"""The port's run accounting and profiler (``repro_torch.telemetry``)
against the JAX package's, on the CPU: ``mfu``/``goodput``/``tokens_per_s``
arithmetic, model FLOPs counted on the ``meta`` device ``==`` JAX's
``eval_shape`` counts (reduced and full width, five archs), telemetry on
and off, ``goodput`` under a rollback, the ``torch.profiler`` window and
its event rows (``==`` JAX's hook's, with ``jax.profiler`` stubbed), and
the ``telemetry.profile`` / ``resilience`` / ``run.serve.faults`` settings:
the same error messages as JAX's and the same materialized document.
"""
import dataclasses
import json
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.core.components as jax_components
import repro.run.kinds  # noqa: F401  (JAX's run kinds)
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.models import build_model as jax_build_model
from repro.run.config import RunError as JaxRunError
from repro.run.config import ServeSettings as JaxServeSettings
from repro.run.config import TrainSettings as JaxTrainSettings
from repro.run.config import parse_run_doc as jax_parse_run_doc
from repro.run.fingerprint import materialize as jax_materialize
from repro.telemetry import ListSink as JaxListSink
from repro.telemetry import ProfilerHook as JaxProfilerHook
from repro.telemetry import TelemetryRecorder as JaxRecorder
from repro.telemetry import accounting as JACC
from repro_torch.config.resolver import load_yaml
from repro_torch.configs import get_config, get_reduced
from repro_torch.configs.shapes import SHAPES
from repro_torch.core.components import register_all
from repro_torch.device import PEAK_FLOPS_BF16, MetaGenerator
from repro_torch.models import build_model
from repro_torch.run import api
from repro_torch.run.config import RunError, ServeSettings, TrainSettings
from repro_torch.run.config import parse_run_doc
from repro_torch.run.fingerprint import materialize
from repro_torch.run.overrides import apply_overrides, parse_overrides
from repro_torch.telemetry import ListSink, ProfilerHook, TelemetryRecorder
from repro_torch.telemetry import accounting as ACC
from repro_torch.telemetry import phases as PH
from repro_torch.telemetry import read_jsonl, validate_rows

ROOT = os.path.join(os.path.dirname(__file__), "..")
QUICKSTART = os.path.join(ROOT, "examples", "configs", "quickstart.yaml")
ARCHS = ["qwen1p5_0p5b", "mamba2_780m", "zamba2_2p7b", "stablelm_1p6b",
         "llama3_8b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Reduced models: their ops are far too small to split across threads,
    and under the suite's parallel workers one thread per core leaves each
    op waiting on descheduled threads.  One thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(_msg):
    pass


# ---------------------------------------------------------------------------
# accounting arithmetic
# ---------------------------------------------------------------------------
def test_mfu_goodput_tokens_per_s_arithmetic():
    """The port's functions ``==`` JAX's on seeded inputs (JAX given the
    port's peak), the peak is the H100's dense bf16 rate, and the edge
    cases (no time, no devices, nothing dispatched) are JAX's."""
    assert PEAK_FLOPS_BF16 == 989.4e12
    rng = np.random.default_rng(1)
    for _ in range(50):
        flops = float(rng.uniform(1e9, 1e15))
        step_s = float(rng.uniform(1e-3, 10))
        n = int(rng.integers(1, 9))
        assert ACC.mfu(flops, step_s, n) == JACC.mfu(flops, step_s, n,
                                                     PEAK_FLOPS_BF16)
        assert ACC.mfu(flops, step_s) == flops / (step_s * 989.4e12)
        prod, disp = int(rng.integers(0, 50)), int(rng.integers(0, 60))
        assert ACC.goodput(prod, disp) == JACC.goodput(prod, disp)
        gb, seq = int(rng.integers(1, 64)), int(rng.integers(1, 4096))
        assert ACC.tokens_per_s(gb, seq, step_s) == \
            JACC.tokens_per_s(gb, seq, step_s)
    assert ACC.mfu(1e12, 0.0) == ACC.mfu(1e12, 1.0, 0) == 0.0
    assert ACC.goodput(0, 0) == 1.0 and ACC.goodput(6, 11) == 6 / 11
    assert ACC.goodput(12, 6) == 1.0
    assert ACC.tokens_per_s(0, 64, 1.0) is None
    assert ACC.tokens_per_s(8, 64, 0.0) is None


# ---------------------------------------------------------------------------
# model FLOPs: meta-device counts == JAX's eval_shape counts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_flops_equal_jax(arch, reduced):
    cfg = get_reduced(arch) if reduced else get_config(arch)
    jcfg = jax_get_reduced(arch) if reduced else jax_get_config(arch)
    loader = SimpleNamespace(global_batch=8,
                             dataset=SimpleNamespace(seq_len=1024))
    got = ACC.flops_per_train_step(build_model(cfg), loader)
    want = JACC.flops_per_train_step(jax_build_model(jcfg), loader)
    assert got == want and got > 0
    for shape in SHAPES:
        assert ACC.model_flops(cfg, SHAPES[shape]) == \
            JACC.model_flops(jcfg, JAX_SHAPES[shape])


def test_flops_of_the_train_phases():
    """6·N·D at 8 × 1024 for the chip smoke run's full-width train phases
    (N counted once for a tied embedding)."""
    loader = SimpleNamespace(global_batch=8,
                             dataset=SimpleNamespace(seq_len=1024))
    want = {"qwen1p5_0p5b": (463987712, 2.2805924020224e13),
            "mamba2_780m": (857379072, 4.2141896146944e13),
            "zamba2_2p7b": (2063676080, 1.0143380668416e14)}
    for arch, (n, flops) in want.items():
        model = build_model(get_config(arch))
        assert ACC.count_param_leaves(model.init(MetaGenerator())) == n
        assert ACC.flops_per_train_step(model, loader) == flops \
            == 6.0 * n * 8 * 1024
    assert ACC.flops_per_train_step(
        build_model(get_reduced("qwen1p5_0p5b")), SimpleNamespace()) is None


# ---------------------------------------------------------------------------
# the train kind: telemetry on/off, mfu, goodput under a rollback
# ---------------------------------------------------------------------------
def _doc(tmp_path, name, *sets):
    doc = load_yaml(QUICKSTART)
    return apply_overrides(doc, parse_overrides(
        [f"dataset.config.prefix={tmp_path / 'qs'}",
         f"run.output_dir={tmp_path / name}", "run.train.steps=4", *sets]))


def _losses(res):
    return [(m["step"], m["loss"]) for m in res["history"]]


def test_telemetry_off_writes_no_file_and_keeps_the_curve(tmp_path):
    on = api.execute_doc(_doc(tmp_path, "on"), device="cpu",
                         write_result=True, log=_quiet)
    off = api.execute_doc(_doc(tmp_path, "off", "run.train.telemetry=false"),
                          device="cpu", write_result=True, log=_quiet)
    assert os.path.exists(tmp_path / "on" / "telemetry.jsonl")
    assert not os.path.exists(tmp_path / "off" / "telemetry.jsonl")
    assert "telemetry" in on and "telemetry" not in off
    assert _losses(on) == _losses(off) and len(_losses(on)) == 4
    # mfu is the run's accounting, not telemetry's: both runs report it
    for res in (on, off):
        flops = ACC.flops_per_train_step(
            build_model(get_reduced("qwen1p5_0p5b")),
            SimpleNamespace(global_batch=8,
                            dataset=SimpleNamespace(seq_len=64)))
        assert res["model_flops_per_step"] == flops
        assert res["mfu"] == pytest.approx(
            flops / (res["wall_s"] / res["steps_dispatched"])
            / PEAK_FLOPS_BF16, rel=1e-3)
        assert res["goodput"] == 1.0 and res["rollback_count"] == 0


def test_goodput_below_one_under_an_injected_rollback(tmp_path):
    """``nan_loss`` at step 2 with no checkpoint before it: the run rolls
    back to the seeded init and replays, 3 + 4 = 7 steps dispatched for 4
    productive; the telemetry has the rollback and resilience/* rows and
    ``run_end`` carries the accounting; events.jsonl holds the events."""
    res = api.execute_doc(_doc(
        tmp_path, "rb", "gym.config.ckpt_every=2",
        "run.train.resilience={sentinel: true, faults: "
        "[{kind: nan_loss, at: 2}]}"), device="cpu", write_result=True,
        log=_quiet)
    clean = api.execute_doc(_doc(tmp_path, "clean"), device="cpu",
                            log=_quiet)
    assert res["steps_dispatched"] == 7 and res["goodput"] == 4 / 7 < 1
    assert res["rollback_count"] == 1 and _losses(res) == _losses(clean)
    assert res["mfu"] == pytest.approx(
        res["model_flops_per_step"] / (res["wall_s"] / 7) / PEAK_FLOPS_BF16,
        rel=1e-3)
    rows = read_jsonl(str(tmp_path / "rb" / "telemetry.jsonl"))
    assert validate_rows(rows) == len(rows)
    events = [r for r in rows if r["type"] == "event"]
    names = [r["name"] for r in events]
    assert names == ["run_start", "rollback", "resilience/fault",
                     "resilience/anomaly", "run_end"]
    end = events[-1]["attrs"]
    assert end == {"goodput": 4 / 7, "rollbacks": 1, "preempted": False}
    with open(tmp_path / "rb" / "events.jsonl") as f:
        assert [json.loads(line)["kind"] for line in f] == ["fault",
                                                            "anomaly"]


# ---------------------------------------------------------------------------
# the phases of a train step (telemetry.phases)
# ---------------------------------------------------------------------------
class _FakeCard:
    """Timing events on a card whose clock the test sets (seconds):
    an event takes ``now`` when recorded and has completed once the card
    has ``reached`` that time."""

    def __init__(self):
        self.now, self.reached = 100.0, float("inf")

    def event(self):
        card = self

        class Event:
            def record(self):
                self.t = card.now

            def query(self):
                return self.t <= card.reached

            def elapsed_time(self, other):
                return 1e3 * (other.t - self.t)

        return Event()


def test_step_phases_put_the_cards_times_on_the_host_clock():
    """A step's phases with fake timing events: the anchor (recorded on an
    idle card as the phases are built) is its host time, so a device row
    lies at that time plus the events' elapsed time; marks made on another
    thread (autograd's device thread) and device rows are written at the
    flush alone, from the loop's thread, and only for events that have
    completed; ``device/ssd_backward`` is parented by its
    ``device/backward``."""
    card = _FakeCard()
    sink, writers = ListSink(), set()
    write = sink.write
    sink.write = lambda row: (writers.add(threading.get_ident()), write(row))
    rec = TelemetryRecorder(sink, run="r", kind="train")
    h0 = time.perf_counter()
    phases = PH.StepPhases(rec, card.event)
    h1 = time.perf_counter()

    def ssd(t0, t1):
        card.now = t0
        with PH.mark("step/ssd_backward", nested=True):
            card.now = t1

    def spans():
        return {r["name"]: r for r in rec.rows if r["type"] == "span"}

    PH.set_current(phases)
    try:
        with PH.mark("step/ssd_backward", nested=True):
            pass    # inside no phase: nothing
        phases.step = 7
        with rec.span("gym/step", step=7):
            card.now = 100.5
            with PH.mark("step/forward"):
                card.now = 101.0
            with PH.mark("step/backward"):
                for t in ((101.25, 101.5), (102.0, 102.25)):
                    th = threading.Thread(target=ssd, args=t)
                    th.start()
                    th.join()
                card.now = 103.0
            with PH.mark("step/optimizer"):
                card.now = 103.5
        assert set(spans()) == {"gym/step", "step/forward", "step/backward",
                                "step/optimizer"}
        card.reached = 102.9        # the backward's last event has not run
        phases.flush()
        assert {n for n in spans() if n.startswith("device/")} == \
            {"device/forward"}
        card.reached = float("inf")
        phases.flush()
    finally:
        PH.set_current(None)
    assert writers == {threading.get_ident()}
    assert validate_rows(rec.rows) == len(rec.rows)
    rows = [r for r in rec.rows if r["type"] == "span"]
    by_id = {r["span_id"]: r for r in rows}
    host = {r["name"]: r for r in rows if r["name"].startswith("step/")}
    ssd_host = [r for r in rows if r["name"] == "step/ssd_backward"]
    assert len(ssd_host) == 2 and all(
        by_id[r["parent_id"]] is host["step/backward"] and r["depth"] == 2
        for r in ssd_host)
    dev = {}
    for r in rows:
        if r["name"].startswith("device/"):
            dev.setdefault(r["name"], []).append(r)
    want = {"device/forward": [(0.5, 1.0)],
            "device/backward": [(1.0, 3.0)],
            "device/ssd_backward": [(1.25, 1.5), (2.0, 2.25)],
            "device/optimizer": [(3.0, 3.5)]}
    assert sorted(dev) == sorted(want)
    for name, ivs in want.items():
        assert len(dev[name]) == len(ivs)
        for r, (a, b) in zip(dev[name], ivs):
            t0, t1 = rec.t0 + r["t0_s"], rec.t0 + r["t1_s"]
            assert h0 + a <= t0 <= h1 + a and h0 + b <= t1 <= h1 + b
            assert r["dur_s"] == pytest.approx(b - a, abs=1e-9)
            assert r["step"] == 7
            phase = name.split("/")[1]
            parent = by_id[r["parent_id"]]
            if phase == "ssd_backward":
                assert parent is dev["device/backward"][0]
            else:
                assert parent is host["step/" + phase]


def _mamba2_loader(tmp_path):
    from repro_torch.data import packed_dataset as PD

    PD.synthetic_dataset(4000, 97, str(tmp_path / "p"), seed=7)
    return PD.ShardedLoader(PD.ChunkedLMDataset(
        PD.PackedDataset(str(tmp_path / "p")), 16), global_batch=2)


def test_marks_record_nothing_without_a_recorder(tmp_path, monkeypatch):
    """With no recorder, or one with spans off, a step of reduced Mamba2
    (its SSD backward included) builds no phases, records no CUDA event
    and opens no ``record_function`` range; a mark is the one null
    context."""
    from repro_torch.core.gym import Gym
    from repro_torch.optim.adamw import AdamW

    def refuse(*a, **k):
        raise AssertionError("a mark recorded with no recorder")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(PH, "StepPhases", refuse)
    assert PH._current is None
    assert PH.mark("step/forward") is PH.mark("step/ssd_backward", True)
    loader = _mamba2_loader(tmp_path)
    for tel in (None, TelemetryRecorder(run="r", kind="train", spans=False)):
        gym = Gym(model=build_model(get_reduced("mamba2_780m")),
                  optimizer=AdamW(lr=1e-3), loader=loader, log_every=1,
                  device="cpu", telemetry=tel)
        out = gym.run(2, state=gym.setup())
        assert int(out["state"]["step"]) == 2 and PH._current is None
        if tel is not None:
            assert tel.counts["span"] == 0


# ---------------------------------------------------------------------------
# the profiler window
# ---------------------------------------------------------------------------
def test_profiler_hook_writes_a_trace_on_the_cpu(tmp_path):
    res = api.execute_doc(_doc(
        tmp_path, "prof", "run.train.telemetry.profile={start_step: 2, "
                          "num_steps: 2}"), device="cpu", write_result=True,
        log=_quiet)
    trace = res["profile_trace"]
    assert trace == str(tmp_path / "prof" / "profile" / "trace_step2.json")
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    rows = read_jsonl(str(tmp_path / "prof" / "telemetry.jsonl"))
    prof = [(r["name"], r["step"], r["attrs"]["path"]) for r in rows
            if r["type"] == "event" and r["name"].startswith("profile_")]
    path = str(tmp_path / "prof" / "profile")
    assert prof == [("profile_start", 2, path), ("profile_stop", 3, path)]
    plain = api.execute_doc(_doc(tmp_path, "plain"), device="cpu",
                            log=_quiet)
    assert _losses(res) == _losses(plain)
    with open(tmp_path / "prof" / "result.json") as f:
        assert json.load(f)["profile_trace"] == trace


def _hook_rows(hook_cls, rec_cls, sink_cls, steps, out_dir):
    """The event rows of a (start 3, 2 steps) hook driven over ``steps``,
    and the hook."""
    sink = sink_cls()
    rec = rec_cls(sink, run="r", kind="train")
    hook = hook_cls(3, 2, out_dir, recorder=rec)
    for s in steps:
        hook.step_begin(s)
        hook.step_end(s)
    hook.close()
    return [(r["name"], r["step"], r.get("attrs")) for r in sink.rows
            if r["type"] == "event"], hook


@pytest.mark.parametrize("steps", [[1, 2, 3, 4, 5, 6], [5, 6, 7],
                                   [1, 2, 3]],
                         ids=["fresh", "resumed-past-start", "cut-short"])
def test_profiler_event_rows_equal_jax(tmp_path, monkeypatch, steps):
    """The window's ``profile_start``/``profile_stop`` rows ``==`` JAX's
    hook's over the same steps (``jax.profiler`` stubbed: this is the
    hook's logic, not XLA's tracer): a resumed run starts at its first step
    past ``start_step``; a run cut inside the window closes it with no stop
    row."""
    import jax

    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: None)
    out = str(tmp_path / "p")
    ours, hook = _hook_rows(ProfilerHook, TelemetryRecorder, ListSink, steps,
                            out_dir=out)
    theirs, jhook = _hook_rows(JaxProfilerHook, JaxRecorder, JaxListSink,
                               steps, out_dir=out)
    assert ours == theirs and ours[0][0] == "profile_start"
    assert hook.done and jhook.done and hook.artifact.startswith(out)
    assert os.path.exists(hook.artifact)


def test_profiler_error_row_equals_jax(tmp_path, monkeypatch):
    """A profiler that cannot start records one ``profile_error`` row with
    the same text in both packages, and the run goes on."""
    import jax

    def refuse(*_a, **_k):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(jax.profiler, "start_trace", refuse)
    monkeypatch.setattr(torch.profiler, "profile", refuse)
    out = str(tmp_path / "p")
    ours, hook = _hook_rows(ProfilerHook, TelemetryRecorder, ListSink,
                            [1, 2, 3, 4], out_dir=out)
    theirs, _ = _hook_rows(JaxProfilerHook, JaxRecorder, JaxListSink,
                           [1, 2, 3, 4], out_dir=out)
    assert ours == theirs == [("profile_error", 3,
                               {"error": "RuntimeError: no profiler here"})]
    assert hook.artifact is None


# ---------------------------------------------------------------------------
# settings: JAX's messages, JAX's materialized document
# ---------------------------------------------------------------------------
BAD_TRAIN = [
    {"telemetry": {"profile": {"start_step": 0}}},
    {"telemetry": {"profile": {"num_steps": 0}}},
    {"telemetry": {"profile": {"bogus": 1}}},
    {"telemetry": {"profile": 5}},
    {"resilience": 7},
    {"resilience": {"bogus": 1}},
    {"resilience": {"max_rollbacks": -1}},
    {"resilience": {"sentinel": {"bogus_knob": 1}}},
    {"resilience": {"sentinel": 3}},
    {"resilience": {"ckpt_retry": {"max_attempts": 0}}},
    {"resilience": {"ckpt_retry": {"retries": 2}}},
    {"resilience": {"faults": "nan_loss"}},
    {"resilience": {"faults": [3]}},
    {"resilience": {"faults": [{"kind": "meteor_strike"}]}},
    {"resilience": {"faults": [{"kind": "nan_loss", "times": -1}]}},
    {"resilience": {"faults": [{"kind": "serve_stall", "seconds": -1}]}},
    {"resilience": {"faults": [{"kind": "nan_loss", "when": 3}]}},
]


@pytest.mark.parametrize("section", BAD_TRAIN,
                         ids=[json.dumps(s)[:40] for s in BAD_TRAIN])
def test_train_settings_errors_equal_jax(section):
    with pytest.raises(JaxRunError) as theirs:
        JaxTrainSettings(**section)
    with pytest.raises(RunError) as ours:
        TrainSettings(**section)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("faults", [
    [{"kind": "serve_stall", "seconds": -0.5}], {"kind": "nope"}, "stall",
    [["serve_stall"]]], ids=["seconds", "kind", "string", "row"])
def test_serve_faults_errors_equal_jax(faults):
    with pytest.raises(JaxRunError) as theirs:
        JaxServeSettings(engine=True, faults=faults)
    with pytest.raises(RunError) as ours:
        ServeSettings(engine=True, faults=faults)
    assert str(ours.value) == str(theirs.value)


def test_settings_normalize_and_materialize_as_jax():
    """A document with a resilience block, a profile window and a serve
    fault schedule: the same settings after coercion, and the same
    materialized document (so the same fingerprint and ``resolved.yaml``)."""
    train = {"resilience": {"sentinel": {"spike_zscore": 5.0},
                            "ckpt_retry": True, "max_rollbacks": 2,
                            "faults": {"kind": "nan_loss", "at": 3}},
             "telemetry": {"profile": {"start_step": 2}}}
    ours, theirs = TrainSettings(**train), JaxTrainSettings(**train)
    assert dataclasses.asdict(ours.resilience) == \
        dataclasses.asdict(theirs.resilience)
    assert dataclasses.asdict(ours.telemetry) == \
        dataclasses.asdict(theirs.telemetry)
    faults = [{"kind": "serve_stall", "at": 3, "seconds": 0.5}]
    assert ServeSettings(engine=True, faults=faults).faults == \
        JaxServeSettings(engine=True, faults=faults).faults

    doc = load_yaml(QUICKSTART)
    doc["run"]["train"].update(train)
    register_all()
    jax_components.register_all()
    got = materialize(parse_run_doc(doc, default_name="q").doc)
    want = jax_materialize(jax_parse_run_doc(doc, default_name="q").doc)
    assert got == want
    assert got["run"]["train"]["resilience"]["faults"] == \
        [{"kind": "nan_loss", "at": 3}]
