"""The port's declarative sweeps (``repro_torch.sweep``, ``run/legacy.py``,
``core/tuner.py``, the ``sweep`` kind, its CLI and the ``launch`` shims)
against the JAX package's, on the CPU.

Sweeps are host code: expansion, trial ids, patched documents, error
messages, records and reports are compared exactly (``==``, byte-equal
files), apart from the wall times a record carries.  JAX's runner cases
(``tests/test_sweep.py``, the sweep cases of ``tests/test_resilience.py``
and ``tests/test_telemetry.py``, ``tests/test_posttrain.py::
test_sweep_drives_sft_trials``) run against the port's runner, mostly
through stub backends; the real ``gym`` backend trains the reduced
quickstart on the CPU, and each trial's ``final_loss`` is ``==`` the port's
own ``train`` run of the trial's document (the ``train`` kind is held
against JAX by ``tests/test_torch_gym.py``).
"""
import json
import os

import pytest
import torch

import repro.core.components  # noqa: F401  (JAX's catalog)
import repro.run.kinds  # noqa: F401  (JAX's run kinds and their settings)
from repro.config.resolver import load_yaml as jax_load_yaml
from repro.run import legacy as JLEG
from repro.sweep import runner as jax_runner_mod
from repro.sweep.report import write_report as jax_write_report
from repro.sweep.runner import SweepRunner as JaxSweepRunner
from repro.sweep.spec import SweepError as JaxSweepError
from repro.sweep.spec import SweepSpec as JaxSweepSpec
from repro.sweep.spec import set_path as jax_set_path

from repro_torch.config.resolver import ConfigError, load_yaml, resolve_config
from repro_torch.core.components import register_all
from repro_torch.run import api
from repro_torch.run import legacy as LEG
from repro_torch.run.cli import main as cli_main
from repro_torch.run.config import RunError, parse_run_doc
from repro_torch.run.overrides import apply_overrides, parse_overrides
from repro_torch.sweep import runner as runner_mod
from repro_torch.sweep.report import (best_trial, comparison_table,
                                      load_records, rank, summarize,
                                      write_report)
from repro_torch.sweep.runner import SweepRunner
from repro_torch.sweep.spec import (SweepError, SweepSpec, apply_patches,
                                    set_path)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = os.path.join(ROOT, "examples", "configs")
QUICKSTART = os.path.join(CONFIGS, "quickstart.yaml")
SWEEPS = ["lr_sweep", "ablation_dryrun"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The gym-backend trials train reduced models, whose ops are far too
    small to split across threads under the suite's parallel workers: one
    thread for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(_msg):
    pass


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# expansion and messages vs JAX
# ---------------------------------------------------------------------------
def _trial_rows(spec):
    return [(t.index, t.trial_id, t.patches, t.seed, spec.trial_config(t))
            for t in spec.trials()]


@pytest.mark.parametrize("name", SWEEPS)
def test_example_sweep_expansion_equals_jax(name):
    path = os.path.join(CONFIGS, f"{name}.yaml")
    ours, theirs = SweepSpec.from_yaml(path), JaxSweepSpec.from_yaml(path)
    assert _trial_rows(ours) == _trial_rows(theirs)
    for field in ("name", "backend", "output_dir", "objective_metric",
                  "objective_mode", "seeds", "seed_path", "steps", "gym_key"):
        assert getattr(ours, field) == getattr(theirs, field), field
    assert len(ours.trials()) == {"lr_sweep": 6, "ablation_dryrun": 12}[name]


EXPANSIONS = {
    "grid x zip x seeds": dict(
        axes=[{"type": "grid", "parameters": {"plan": ["ddp", "fsdp"],
                                              "opt.lr": [1e-4, 0.0003]}},
              {"type": "zip", "parameters": {"opt.wd": [0.0, 0.1, 1.5e-05],
                                             "gym.config.seed": [1, 2, 3]}}],
        seeds=[0, 7], seed_path="gym.config.seed"),
    "list with odd values": dict(
        axes=[{"type": "list", "trials": [
            {"plan": "fsdp tp/2", "opt.lr": 1e-8},
            {"plan": None, "opt.lr": 2.5},
            {"plan": [1, "a"], "opt.lr": True},
            {"xs.1": "x", "opt.lr": -3}]}]),
    "list index leaves": dict(
        axes=[{"type": "grid", "parameters": {"xs.0": [1, 2], "xs.1": [3]}}]),
    "no axes": dict(axes=[]),
    "no axes, seeds": dict(axes=[], seeds=[3, 4]),
}


@pytest.mark.parametrize("case", sorted(EXPANSIONS))
def test_expansion_and_trial_ids_equal_jax(case):
    """Trial ids feed directory names and resume keys: float formatting,
    slugs and short labels byte-equal to JAX's."""
    base = {"opt": {"lr": 0.1, "wd": 0.0}, "plan": "ddp", "xs": [0, 0],
            "gym": {"config": {"seed": 0}}}
    doc = dict(name="t", base=base, **EXPANSIONS[case])
    ours, theirs = SweepSpec.from_dict(doc), JaxSweepSpec.from_dict(doc)
    assert _trial_rows(ours) == _trial_rows(theirs)


BAD_SPECS = {
    "zip lengths": dict(axes=[{"type": "zip", "parameters": {
        "opt.lr": [0.1, 0.2], "opt.wd": [0.0]}}]),
    "unknown axis": dict(axes=[{"type": "random",
                                "parameters": {"plan": ["ddp"]}}]),
    "duplicate path": dict(axes=[{"type": "grid",
                                  "parameters": {"plan": ["ddp"]}},
                                 {"type": "list", "trials": [{"plan": "x"}]}]),
    "values not a list": dict(axes=[{"type": "grid",
                                     "parameters": {"plan": "ddp"}}]),
    "empty values": dict(axes=[{"type": "grid", "parameters": {"plan": []}}]),
    "no parameters": dict(axes=[{"type": "zip"}]),
    "list rows": dict(axes=[{"type": "list", "trials": [1]}]),
    "list empty": dict(axes=[{"type": "list", "trials": []}]),
    "axis not a mapping": dict(axes=[3]),
    "axes not a list": dict(axes={"type": "grid"}),
    "seeds without path": dict(seeds=[0, 1], seed_path=None),
    "typo path": dict(axes=[{"type": "grid",
                             "parameters": {"opt.typo": [1]}}]),
    "unknown key": dict(extra_key=1),
    "backend": dict(backend="warp"),
    "mode": dict(objective={"metric": "x", "mode": "best"}),
    "objective": dict(objective=3),
    "retry": dict(retry=3),
    "base and base_config": dict(base_config="x.yaml"),
    "duplicate ids": dict(axes=[{"type": "list", "trials": [
        {"plan": "a b"}, {"plan": "a-b"}]}]),
}


@pytest.mark.parametrize("case", sorted(BAD_SPECS))
def test_spec_errors_equal_jax(case):
    base = {"opt": {"lr": 0.1, "wd": 0.0}, "plan": "ddp",
            "gym": {"config": {"seed": 0}}}
    doc = dict(name="t", base=base, **BAD_SPECS[case])
    with pytest.raises(SweepError) as ours:
        SweepSpec.from_dict(doc)
    with pytest.raises(JaxSweepError) as theirs:
        JaxSweepSpec.from_dict(doc)
    assert str(ours.value) == str(theirs.value)


SET_PATH_CASES = [
    ({"known": 1}, "typo", False),
    ({"a": {}}, "a.middle.leaf", False),
    ({"a": {}}, "a.nope.deep", True),
    ({"xs": [1, 2]}, "xs.5", False),
    ({"xs": [1, 2]}, "xs.first", False),
    ({"a": 3}, "a.b.c", False),
    ({"a": 3}, "a.b", False),
    ({"a": 1}, "a..b", False),
    ({"a": 1}, "", False),
    ({"a": {"b": [{"c": 1}]}}, "a.b.0.d", False),
]


@pytest.mark.parametrize("cfg,path,create", SET_PATH_CASES,
                         ids=[repr(p) for _, p, _ in SET_PATH_CASES])
def test_set_path_errors_equal_jax(cfg, path, create):
    with pytest.raises(SweepError) as ours:
        set_path(json.loads(json.dumps(cfg)), path, 0, create_missing=create)
    with pytest.raises(JaxSweepError) as theirs:
        jax_set_path(json.loads(json.dumps(cfg)), path, 0,
                     create_missing=create)
    assert str(ours.value) == str(theirs.value)


def test_set_path_and_apply_patches():
    d = {"a": {"b": {"c": 1}}, "xs": [{"v": 1}, {"v": 2}]}
    set_path(d, "a.b.c", 2)
    set_path(d, "xs.1.v", 9)
    set_path(d, "xs.-2", "replaced")
    assert d == {"a": {"b": {"c": 2}}, "xs": ["replaced", {"v": 9}]}
    e = {"a": {}}
    set_path(e, "a.new", 5, create_missing=True)
    assert e == {"a": {"new": 5}}
    base = {"a": {"b": 1}}
    out = apply_patches(base, {"a.b": 2})
    assert base["a"]["b"] == 1 and out["a"]["b"] == 2


# ---------------------------------------------------------------------------
# the runner with stub backends (JAX's tests/test_sweep.py cases)
# ---------------------------------------------------------------------------
BASE = {"opt": {"lr": 0.1, "wd": 0.0}, "plan": "ddp",
        "gym": {"config": {"seed": 0}}}


def _spec(cls=SweepSpec, **kw):
    kw.setdefault("name", "t")
    kw.setdefault("base", BASE)
    return cls.from_dict(kw)


def _stub_spec(tmp_path, fail_ids=(), cls=SweepSpec, sub="sweep"):
    spec = _spec(cls, axes=[{"type": "grid",
                             "parameters": {"opt.lr": [0.1, 0.2, 0.3]}}],
                 output_dir=str(tmp_path / sub))
    calls = []

    def backend_factory(s):
        def run(raw):
            calls.append(raw["opt"]["lr"])
            if raw["opt"]["lr"] in fail_ids:
                raise RuntimeError("boom")
            return {"final_loss": raw["opt"]["lr"] * 2, "wall_s": 0.0}

        return run

    return spec, backend_factory, calls


def _lines(spec):
    with open(os.path.join(spec.output_dir, "records.jsonl")) as f:
        return f.readlines()


def test_runner_writes_one_jsonl_record_per_trial(tmp_path, monkeypatch):
    spec, factory, calls = _stub_spec(tmp_path)
    monkeypatch.setitem(runner_mod.BACKENDS, "gym", factory)
    records = SweepRunner(spec).run()
    assert [r["status"] for r in records] == ["ok"] * 3
    lines = _lines(spec)
    assert len(lines) == 3
    assert json.loads(lines[0])["metrics"]["final_loss"] == 0.2
    assert os.path.exists(os.path.join(spec.output_dir, "spec.json"))


def test_runner_resumes_by_skipping_completed_trials(tmp_path, monkeypatch):
    spec, factory, calls = _stub_spec(tmp_path)
    monkeypatch.setitem(runner_mod.BACKENDS, "gym", factory)
    SweepRunner(spec).run()
    records = SweepRunner(spec).run()
    assert len(calls) == 3, "resume must not re-execute completed trials"
    assert all(r.get("resumed") for r in records)
    assert len(_lines(spec)) == 3, "resume must not duplicate records"


def test_runner_retries_failed_trials_on_resume(tmp_path, monkeypatch):
    spec, factory, calls = _stub_spec(tmp_path, fail_ids={0.2})
    monkeypatch.setitem(runner_mod.BACKENDS, "gym", factory)
    records = SweepRunner(spec).run()
    assert [r["status"] for r in records] == ["ok", "failed", "ok"]
    assert "boom" in records[1]["error"]
    spec2, factory2, calls2 = _stub_spec(tmp_path)
    monkeypatch.setitem(runner_mod.BACKENDS, "gym", factory2)
    records = SweepRunner(spec2).run()
    assert calls2 == [0.2], "only the failed trial re-runs"
    assert [r["status"] for r in records] == ["ok", "ok", "ok"]


def test_runner_redo_replaces_records_without_duplicates(tmp_path,
                                                         monkeypatch):
    spec, factory, calls = _stub_spec(tmp_path)
    monkeypatch.setitem(runner_mod.BACKENDS, "gym", factory)
    SweepRunner(spec).run()
    SweepRunner(spec).run(resume=False)
    assert len(calls) == 6 and len(_lines(spec)) == 3


def test_runner_max_trials_caps_new_work(tmp_path, monkeypatch):
    spec, factory, calls = _stub_spec(tmp_path)
    monkeypatch.setitem(runner_mod.BACKENDS, "gym", factory)
    records = SweepRunner(spec).run(max_trials=2)
    assert len(calls) == 2 and len(records) == 2
    records = SweepRunner(spec).run(max_trials=2)
    assert len(calls) == 3 and len(records) == 3
    assert [bool(r.get("resumed")) for r in records] == [True, True, False]


def test_runner_without_output_dir_is_in_memory_only(tmp_path, monkeypatch):
    spec, factory, calls = _stub_spec(tmp_path)
    spec.output_dir = None
    monkeypatch.setitem(runner_mod.BACKENDS, "gym", factory)
    records = SweepRunner(spec).run()
    assert len(records) == 3 and not (tmp_path / "sweep").exists()


def test_stub_backend_through_both_runners(tmp_path, monkeypatch):
    """One stub backend (one failing trial) driven through JAX's runner and
    the port's: ``spec.json`` and the reports byte-equal, the records
    ``==`` but for their wall times and the traceback's frames (the two
    runners' own file paths): its last line, the error, is ``==``."""
    ours, factory, _ = _stub_spec(tmp_path, fail_ids={0.3}, sub="port")
    theirs, jfactory, _ = _stub_spec(tmp_path, fail_ids={0.3},
                                     cls=JaxSweepSpec, sub="jax")
    monkeypatch.setitem(runner_mod.BACKENDS, "gym", factory)
    monkeypatch.setitem(jax_runner_mod.BACKENDS, "gym", jfactory)
    SweepRunner(ours).run()
    JaxSweepRunner(theirs).run()

    def strip(line):
        rec = json.loads(line)
        rec.pop("wall_s")
        if "traceback" in rec:
            rec["traceback"] = rec["traceback"].strip().splitlines()[-1]
        return rec

    got, want = _lines(ours), _lines(theirs)
    assert len(got) == 3 and [strip(x) for x in got] == \
        [strip(x) for x in want]
    assert json.loads(got[2])["traceback"].strip().endswith(
        "RuntimeError: boom")
    write_report(ours)
    jax_write_report(theirs)
    for fn in ("spec.json", "report.json", "report.txt"):
        assert _read(os.path.join(ours.output_dir, fn)) == \
            _read(os.path.join(theirs.output_dir, fn)), fn


def test_tuner_grid_creates_missing_leaf_keys(monkeypatch):
    from repro_torch.core.tuner import grid

    def factory(s):
        return lambda raw: {
            "final_loss": float(raw["gym"]["config"]["grad_accum"]),
            "tokens_per_s": 1, "wall_s": 0.0}

    monkeypatch.setitem(runner_mod.BACKENDS, "gym", factory)
    res = grid({"gym": {"config": {"seed": 0}}},
               {"gym.config.grad_accum": [2, 1]}, steps=1)
    assert [r["trial"] for r in res] == [{"gym.config.grad_accum": 1},
                                         {"gym.config.grad_accum": 2}]


def _records():
    return [
        {"trial_id": "a", "index": 0, "status": "ok",
         "metrics": {"final_loss": 3.0, "tokens_per_s": 10}},
        {"trial_id": "b", "index": 1, "status": "ok",
         "metrics": {"final_loss": 1.0, "tokens_per_s": 30}},
        {"trial_id": "c", "index": 2, "status": "failed", "error": "x",
         "error_type": "OSError", "failure_kind": "transient"},
    ]


def test_report_functions_equal_jax():
    from repro.sweep import report as JR

    for metric, mode in (("final_loss", "min"), ("tokens_per_s", "max"),
                         ("absent", "min")):
        assert rank(_records(), metric, mode) == \
            JR.rank(_records(), metric, mode)
        assert best_trial(_records(), metric, mode) == \
            JR.best_trial(_records(), metric, mode)
        assert comparison_table(_records(), metric, mode) == \
            JR.comparison_table(_records(), metric, mode)
        assert summarize(_records(), metric, mode) == \
            JR.summarize(_records(), metric, mode)
    assert [r["trial_id"] for r in rank(_records(), "final_loss")] == \
        ["b", "a", "c"]
    lines = comparison_table(_records(), "final_loss").splitlines()
    assert lines[0].split()[:3] == ["rank", "trial", "final_loss"]
    assert "failed" in lines[-1] and "-" in lines[-1]
    with pytest.raises(SweepError, match="rank mode"):
        rank(_records(), "final_loss", "best")


def test_write_report_roundtrip(tmp_path, monkeypatch):
    spec, factory, _ = _stub_spec(tmp_path)
    monkeypatch.setitem(runner_mod.BACKENDS, "gym", factory)
    records = SweepRunner(spec).run()
    summary = write_report(spec, records)
    assert summary["best"]["trial_id"] == "lr=0.1"
    assert summary["by_status"] == {"ok": 3}
    with open(os.path.join(spec.output_dir, "report.json")) as f:
        assert json.load(f)["best"]["value"] == pytest.approx(0.2)
    assert len(load_records(spec.output_dir)) == 3
    with pytest.raises(SweepError, match="no sweep records"):
        load_records(str(tmp_path / "nowhere"))


# ---------------------------------------------------------------------------
# resilience and telemetry sweep cases (JAX's tests/test_resilience.py,
# tests/test_telemetry.py)
# ---------------------------------------------------------------------------
def _chaos_sweep(tmp_path, fail):
    spec = SweepSpec.from_dict({
        "name": "chaos", "base": {"opt": {"lr": 0.1}},
        "axes": [{"type": "grid",
                  "parameters": {"opt.lr": [0.1, 0.2, 0.3]}}],
        "output_dir": str(tmp_path / "sweep"), "seed_path": None,
    })
    calls = []

    def factory(s):
        def run(raw):
            lr = raw["opt"]["lr"]
            calls.append(lr)
            planned = fail.get(lr)
            if planned:
                raise planned.pop(0)
            return {"final_loss": lr * 2, "wall_s": 0.0}

        return run

    return spec, factory, calls


def test_sweep_failure_records_carry_error_type(tmp_path, monkeypatch):
    spec, factory, _ = _chaos_sweep(tmp_path,
                                    {0.2: [ValueError("bad shape")]})
    monkeypatch.setitem(runner_mod.BACKENDS, "gym", factory)
    records = SweepRunner(spec).run()
    failed = [r for r in records if r["status"] == "failed"]
    assert len(failed) == 1
    assert failed[0]["error_type"] == "ValueError"
    assert failed[0]["failure_kind"] == "deterministic"
    assert summarize(records, "final_loss")["failures_by_type"] == \
        {"ValueError (deterministic)": 1}


def test_sweep_retry_failed_reruns_transient_keeps_deterministic(
        tmp_path, monkeypatch):
    spec, factory, calls = _chaos_sweep(
        tmp_path, {0.2: [OSError("flaky fs")], 0.3: [ValueError("bad")]})
    monkeypatch.setitem(runner_mod.BACKENDS, "gym", factory)
    first = SweepRunner(spec).run()
    assert [r["status"] for r in first] == ["ok", "failed", "failed"]
    assert first[1]["failure_kind"] == "transient"
    calls.clear()
    second = SweepRunner(spec).run(retry_failed=True)
    assert calls == [0.2]
    by_lr = {r["patches"]["opt.lr"]: r for r in second}
    assert by_lr[0.1]["resumed"] and by_lr[0.1]["status"] == "ok"
    assert by_lr[0.2]["status"] == "ok" and not by_lr[0.2].get("resumed")
    assert by_lr[0.3]["status"] == "failed" and by_lr[0.3]["resumed"]


def test_sweep_in_trial_retry_policy_absorbs_transients(tmp_path,
                                                        monkeypatch):
    spec, factory, calls = _chaos_sweep(
        tmp_path, {0.2: [OSError("once"), OSError("twice")]})
    spec.retry = {"max_attempts": 3, "base_delay_s": 0.001}
    monkeypatch.setitem(runner_mod.BACKENDS, "gym", factory)
    records = SweepRunner(spec).run()
    assert [r["status"] for r in records] == ["ok"] * 3
    assert records[1]["trial_retries"] == 2
    assert calls.count(0.2) == 3


def test_sweep_retry_exhaustion_classifies_the_cause(tmp_path, monkeypatch):
    spec, factory, _ = _chaos_sweep(tmp_path,
                                    {0.2: [OSError("a"), OSError("b")]})
    spec.retry = {"max_attempts": 2, "base_delay_s": 0.001}
    monkeypatch.setitem(runner_mod.BACKENDS, "gym", factory)
    records = SweepRunner(spec).run()
    assert records[1]["status"] == "failed"
    assert records[1]["error_type"] == "OSError"
    assert records[1]["failure_kind"] == "transient"


def test_sweep_records_flow_to_telemetry(tmp_path, monkeypatch):
    from repro_torch.telemetry.events import validate_rows
    from repro_torch.telemetry.recorder import TelemetryRecorder
    from repro_torch.telemetry.sinks import ListSink

    spec = SweepSpec.from_dict({
        "name": "tsweep",
        "base": {"opt": {"lr": 0.1}, "arch": "a", "shape": "b"},
        "axes": [{"type": "grid",
                  "parameters": {"opt.lr": [0.1, 0.2, 0.3]}}],
        "output_dir": str(tmp_path / "sweep"),
    })

    def factory(s):
        def run(raw, trial=None):
            lr = raw["opt"]["lr"]
            if lr == 0.3:
                raise RuntimeError("boom")
            return {"final_loss": lr * 2, "wall_s": 0.0,
                    "collectives": {"all_gather": 3}}

        run.accepts_trial = True
        return run

    monkeypatch.setitem(runner_mod.BACKENDS, "gym", factory)
    rec = TelemetryRecorder(ListSink(), run="t", kind="sweep",
                            fingerprint="sha256:feed")
    records = SweepRunner(spec, telemetry=rec).run()
    assert [r["status"] for r in records] == ["ok", "ok", "failed"]
    assert records[0]["run_dir"] == os.path.join("trials", "lr=0.1")
    assert validate_rows(rec.rows) == len(rec.rows)
    metric_rows = [r for r in rec.rows if r["type"] == "metric"]
    assert len(metric_rows) == 2
    for r in metric_rows:
        assert r["attrs"]["status"] == "ok"
        assert "trial_wall_s" in r["data"] and "final_loss" in r["data"]
        assert "collectives" not in r["data"]
    events = [r for r in rec.rows if r["type"] == "event"]
    assert [e["name"] for e in events] == ["trial_failed"]
    assert events[0]["attrs"]["error"] == "RuntimeError: boom"


# ---------------------------------------------------------------------------
# the dryrun backend and the device
# ---------------------------------------------------------------------------
def test_dryrun_backend_refuses_before_any_record(tmp_path):
    """The dryrun backend is ported (it refused before A9b's dryrun half):
    two trials of a reduced dryrun document, each traced on its own fake
    2 x 2 world, write ``ok`` records with JAX's metric keys and
    ``roofline_step_s`` the largest term, and leave no process group."""
    import torch.distributed as dist

    from repro_torch.sweep.runner import _DRYRUN_KEEP

    out = str(tmp_path / "abl")
    base = {
        "run": {"kind": "dryrun"},
        "arch": {"component_key": "arch_config",
                 "variant_key": "qwen1p5_0p5b", "config": {"reduced": True}},
        "shape": {"component_key": "shape", "variant_key": "custom",
                  "config": {"seq_len": 32, "global_batch": 4,
                             "kind": "train"}},
        "mesh": {"component_key": "mesh_provider", "variant_key": "local",
                 "config": {"dp": 2, "tp": 2}},
        "plan": {"component_key": "sharding_plan", "variant_key": "ddp"},
    }
    spec = SweepSpec.from_dict({
        "name": "abl", "backend": "dryrun", "base": base,
        "axes": [{"type": "grid",
                  "parameters": {"plan.variant_key": ["ddp", "fsdp"]}}],
        "objective": {"metric": "roofline_step_s", "mode": "min"},
        "output_dir": out})
    records = SweepRunner(spec, device="cpu").run()
    assert [r["status"] for r in records] == ["ok", "ok"]
    for r in records:
        m = r["metrics"]
        assert set(m) == set(_DRYRUN_KEEP) | {"roofline_step_s"}
        assert m["chips"] == 4 and m["mesh"] == "2x2"
        assert m["roofline_step_s"] == max(
            m["compute_term_s"], m["memory_term_s"], m["collective_term_s"])
    assert len(load_records(out)) == 2
    assert not dist.is_initialized()


def test_dryrun_sweep_through_the_cli_refuses(tmp_path, capsys):
    """``ablation_dryrun.yaml`` runs through the CLI (it refused before):
    its first trial (full-width StableLM-1.6B under ``ddp`` on a fake
    world of 256 ranks) is ``ok``, and the report ranks it."""
    out = str(tmp_path / "abl")
    rc = cli_main(["sweep", "--config",
                   os.path.join(CONFIGS, "ablation_dryrun.yaml"),
                   "--output-dir", out, "--device", "cpu",
                   "--max-trials", "1"])
    text = capsys.readouterr().out
    assert rc == 0, text
    [record] = load_records(out)
    assert record["status"] == "ok"
    assert record["trial_id"] == "plan_name=ddp__scan_block=1"
    assert record["metrics"]["chips"] == 256
    assert "best trial: plan_name=ddp__scan_block=1" in text


def test_gym_sweep_without_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the trials would train on it")
    from repro_torch.device import NoDeviceError

    spec = SweepSpec.from_dict({"name": "s", "base": load_yaml(QUICKSTART),
                                "output_dir": str(tmp_path / "s")})
    with pytest.raises(NoDeviceError):
        SweepRunner(spec).run()
    assert not (tmp_path / "s").exists()


# ---------------------------------------------------------------------------
# legacy conversions vs JAX
# ---------------------------------------------------------------------------
def _qs_graph():
    return {k: v for k, v in load_yaml(QUICKSTART).items() if k != "run"}


TRAIN_DOCS = {
    "bare graph": (lambda: _qs_graph(), {}),
    "bare graph, settings": (lambda: _qs_graph(),
                             dict(steps=7, gym_key="g", resume="auto",
                                  name="n", output_dir="o")),
    "train doc": (lambda: load_yaml(QUICKSTART), dict(steps=3, resume=True)),
    "sft doc, foreign sections": (
        lambda: {**_qs_graph(), "run": {
            "kind": "sft", "name": "x", "sft": {"steps": 2, "lora": {
                "rank": 4}}, "dpo": {"beta": 0.1}, "dryrun": {},
            "train": {"steps": 9}}},
        dict(steps=5, resume=False)),
    "serve doc becomes train": (
        lambda: {**_qs_graph(), "run": {"kind": "serve", "serve": {
            "batch": 2}}}, dict(steps=1)),
}


@pytest.mark.parametrize("case", sorted(TRAIN_DOCS))
def test_legacy_train_doc_equals_jax(case):
    make, kw = TRAIN_DOCS[case]
    assert LEG.legacy_train_doc(make(), **kw) == \
        JLEG.legacy_train_doc(make(), **kw)


DRYRUN_DOCS = {
    "minimal": {"arch": "stablelm-1.6b", "shape": "train_4k"},
    "every key": {"arch": "deepseek-v3-671b", "shape": "decode_32k",
                  "plan_name": "fsdp_tp", "scan_block": 2,
                  "multi_pod": True, "mla_absorb": True, "grad_accum": 4,
                  "serve_bf16": True, "bf16_params": True},
    "mesh split": {"arch": "qwen1.5-0.5b", "shape": "train_4k",
                   "mesh_split": "32x8", "plan_name": "ddp"},
    "unknown key": {"arch": "a", "shape": "b", "typo": 1},
    "no shape": {"arch": "qwen1.5-0.5b"},
    "bad split": {"arch": "qwen1.5-0.5b", "shape": "s", "mesh_split": "32"},
    "split and multi pod": {"arch": "qwen1.5-0.5b", "shape": "s",
                            "mesh_split": "4x2", "multi_pod": True},
}


@pytest.mark.parametrize("case", sorted(DRYRUN_DOCS))
def test_legacy_dryrun_doc_equals_jax(case):
    """The dryrun converters only build documents: ``==`` JAX's, or the
    same error message."""
    flat = DRYRUN_DOCS[case]
    try:
        want = JLEG.legacy_dryrun_doc(dict(flat), name="t",
                                      settings={"x": 1})
    except Exception as e:  # JAX's RunError
        with pytest.raises(RunError) as ours:
            LEG.legacy_dryrun_doc(dict(flat), name="t", settings={"x": 1})
        assert str(ours.value) == str(e)
        return
    assert LEG.legacy_dryrun_doc(dict(flat), name="t",
                                 settings={"x": 1}) == want


# ---------------------------------------------------------------------------
# the sweep kind's documents
# ---------------------------------------------------------------------------
def test_sweep_documents_parse_as_jax():
    from repro.run.config import parse_run_doc as jax_parse

    for name in SWEEPS:
        path = os.path.join(CONFIGS, f"{name}.yaml")
        ours = parse_run_doc(load_yaml(path), default_name=name)
        theirs = jax_parse(jax_load_yaml(path), default_name=name)
        assert (ours.kind, ours.name, ours.output_dir, ours.settings,
                ours.doc) == (theirs.kind, theirs.name, theirs.output_dir,
                              theirs.settings, theirs.doc)
    inline = {"run": {"kind": "sweep", "name": "r",
                      "sweep": {"base": BASE, "axes": []}}}
    assert parse_run_doc(inline).doc == jax_parse(inline).doc
    assert parse_run_doc(inline).output_dir == \
        os.path.join("results", "sweeps", "r")
    with pytest.raises(RunError, match="sweep spec but was launched"):
        parse_run_doc({"sweep": {"base": BASE}}, kind="train")
    with pytest.raises(RunError, match="no sweep spec"):
        parse_run_doc({"run": {"kind": "sweep"}})


# ---------------------------------------------------------------------------
# the real gym backend on the CPU
# ---------------------------------------------------------------------------
def _base(tmp_path, *sets):
    doc = load_yaml(QUICKSTART)
    doc.pop("run")
    return apply_overrides(doc, parse_overrides(
        [f"dataset.config.prefix={tmp_path / 'qs'}", *sets]))


def _own_train_loss(spec, trial, tmp_path):
    """The port's own ``train`` run of the trial's patched document."""
    doc = LEG.legacy_train_doc(spec.trial_config(trial), steps=spec.steps,
                               name="own", output_dir=str(tmp_path / "own"))
    return api.execute_doc(doc, device="cpu", log=_quiet)["final_loss"]


def test_gym_backend_sweep_resumes_and_equals_train_runs(tmp_path,
                                                         monkeypatch):
    """Reduced quickstart, 2 trials x 2 steps on the CPU: records, resume
    (no trial runs again), a lost ``records.jsonl`` whose checkpoints
    survived (the trial's ``result.json`` reused), and a lost
    ``result.json`` too (the trial retrained from scratch): every
    ``final_loss`` ``==`` the port's own train run of the trial's
    document."""
    base = _base(tmp_path, "gym.config.ckpt_every=2")
    spec = SweepSpec.from_dict({
        "name": "mini", "backend": "gym", "steps": 2, "base": base,
        "output_dir": str(tmp_path / "mini"),
        "axes": [{"type": "grid",
                  "parameters": {"optimizer.config.weight_decay": [0.0, 0.1]}}],
        "seeds": [3]})
    records = SweepRunner(spec, device="cpu").run()
    assert [r["status"] for r in records] == ["ok", "ok"]
    losses = [r["metrics"]["final_loss"] for r in records]
    for trial, loss in zip(spec.trials(), losses):
        assert loss == _own_train_loss(spec, trial, tmp_path)
    for rec in records:
        assert rec["metrics"]["tokens_per_s"] > 0
        assert rec["metrics"]["steps"] == 2
        trial_dir = tmp_path / "mini" / rec["run_dir"]
        assert (trial_dir / "result.json").exists()
        assert sorted(os.listdir(trial_dir / "ckpt")) == ["step_00000002"]

    ran = []
    real = runner_mod.SweepRunner._run_one

    def counting(self, backend, trial, total):
        ran.append(trial.trial_id)
        return real(self, backend, trial, total)

    monkeypatch.setattr(runner_mod.SweepRunner, "_run_one", counting)
    again = SweepRunner(spec, device="cpu").run()
    assert ran == [] and all(r.get("resumed") for r in again)

    os.remove(tmp_path / "mini" / "records.jsonl")
    os.remove(tmp_path / "mini" / records[1]["run_dir"] / "result.json")
    third = SweepRunner(spec, device="cpu").run()
    assert len(ran) == 2 and [r["status"] for r in third] == ["ok", "ok"]
    # trial 0: the no-op resume kept its result.json, which is reused
    # (its wall time too); trial 1: nothing to reuse, retrained from step 0
    assert third[0]["metrics"] == records[0]["metrics"]
    assert (tmp_path / "mini" / records[1]["run_dir"] / "result.json").exists()
    assert [r["metrics"]["final_loss"] for r in third] == losses
    summary = write_report(spec)
    assert summary["best"]["value"] == min(losses)


def test_tuner_grid_trains_on_the_cpu(tmp_path):
    from repro_torch.core.tuner import grid

    res = grid(_base(tmp_path), {"optimizer.config.weight_decay": [0.0, 0.1]},
               steps=2, device="cpu")
    assert {r["trial"]["optimizer.config.weight_decay"] for r in res} == \
        {0.0, 0.1}
    assert all(r["final_loss"] > 0 and r["tokens_per_s"] > 0 for r in res)
    assert res[0]["final_loss"] <= res[-1]["final_loss"]


def test_sweep_drives_sft_trials(tmp_path):
    """A sweep whose base declares ``kind: sft`` runs sft trials (the
    kind-preserving ``legacy_train_doc``) and reports their losses."""
    base = {
        "run": {"kind": "sft", "name": "sweepbase",
                "sft": {"steps": 2, "lora": {"rank": 4}}},
        "arch": {"component_key": "arch_config",
                 "variant_key": "qwen1p5_0p5b", "config": {"reduced": True}},
        "model": {"component_key": "model", "variant_key": "auto",
                  "config": {"arch_config": {"instance_key": "arch"}}},
        "optimizer": {"component_key": "optimizer", "variant_key": "adamw",
                      "config": {"lr": 0.002, "weight_decay": 0.0}},
        "dataset": {"component_key": "dataset", "variant_key": "sft_synthetic",
                    "config": {"seq_len": 24, "vocab": 512,
                               "n_examples": 64, "seed": 0}},
        "loader": {"component_key": "loader", "variant_key": "sharded",
                   "config": {"dataset": {"instance_key": "dataset"},
                              "global_batch": 4}},
        "gym": {"component_key": "gym", "variant_key": "standard",
                "config": {"model": {"instance_key": "model"},
                           "optimizer": {"instance_key": "optimizer"},
                           "loader": {"instance_key": "loader"},
                           "log_every": 1, "prefetch": 0}},
    }
    spec = SweepSpec.from_dict({
        "name": "lora-rank", "backend": "gym", "steps": 2,
        "base": base, "output_dir": str(tmp_path / "sweep"),
        "axes": [{"type": "grid",
                  "parameters": {"run.sft.lora.rank": [2, 4]}}],
    })
    records = SweepRunner(spec, device="cpu").run()
    assert [r["status"] for r in records] == ["ok", "ok"]
    for r in records:
        assert r["metrics"]["final_loss"] > 0
    with open(tmp_path / "sweep" / "trials" / records[0]["trial_id"] /
              "result.json") as f:
        assert json.load(f)["kind"] == "sft"


def test_sweep_patch_to_unknown_variant_fails_trial(tmp_path):
    spec = SweepSpec.from_dict({
        "name": "bad-variant", "backend": "gym", "steps": 1,
        "base": _base(tmp_path), "output_dir": str(tmp_path / "s"),
        "axes": [{"type": "list",
                  "trials": [{"optimizer.variant_key": "nonexistent"}]}],
    })
    records = SweepRunner(spec, device="cpu").run()
    assert records[0]["status"] == "failed"
    assert "unknown variant" in records[0]["error"]
    assert records[0]["failure_kind"] == "deterministic"


def test_resolver_errors_of_patched_trials():
    register_all()
    raw = load_yaml(QUICKSTART)
    spec = SweepSpec.from_dict({
        "name": "extra", "backend": "gym", "base": raw,
        "create_missing": True,
        "axes": [{"type": "grid",
                  "parameters": {"optimizer.config.learning_rate": [1.0]}}]})
    with pytest.raises(ConfigError, match="unexpected config keys"):
        resolve_config({k: v for k, v in spec.trial_config(
            spec.trials()[0]).items() if k != "run"})
    spec = SweepSpec.from_dict({
        "name": "var", "backend": "gym", "base": raw,
        "axes": [{"type": "list",
                  "trials": [{"optimizer.config.lr": "${undefined_lr}"}]}]})
    with pytest.raises(ConfigError, match="undefined variable"):
        resolve_config({k: v for k, v in spec.trial_config(
            spec.trials()[0]).items() if k != "run"})


# ---------------------------------------------------------------------------
# the CLI, validate and the shims
# ---------------------------------------------------------------------------
def test_cli_list_expands_without_running(capsys):
    rc = cli_main(["sweep", "--config",
                   os.path.join(CONFIGS, "ablation_dryrun.yaml"), "--list"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "trials=12" in out and "plan_name=ddp__scan_block=1" in out
    spec = JaxSweepSpec.from_yaml(os.path.join(CONFIGS,
                                               "ablation_dryrun.yaml"))
    for t in spec.trials():
        assert f"  [{t.index}] {t.trial_id}: {json.dumps(t.patches)}" in out


def test_cli_rejects_malformed_spec(tmp_path, capsys):
    bad = tmp_path / "bad.yaml"
    bad.write_text("sweep:\n  backend: warp\n  base: {a: 1}\n")
    assert cli_main(["sweep", "--config", str(bad), "--list"]) == 2
    assert "unknown backend" in capsys.readouterr().err


def test_cli_flags_through_a_stub_backend(tmp_path, monkeypatch, capsys):
    """``--max-trials``, resume, ``--report-only``, ``--retry-failed``,
    ``--redo``, ``--set`` and ``--output-dir`` on ``lr_sweep.yaml``, every
    trial on ``--device cpu``; exit 1 while a trial has failed."""
    calls = []
    fail = {0.001: [OSError("flaky")], 0.0003: [ValueError("bad")]}

    def factory(s, device=None):
        assert str(device) == "cpu"

        def run(raw):
            lr = raw["optimizer"]["config"]["lr"]
            calls.append((lr, raw["gym"]["config"]["seed"]))
            if fail.get(lr):
                raise fail[lr].pop(0)
            return {"final_loss": lr + raw["gym"]["config"]["seed"]}

        return run

    monkeypatch.setitem(runner_mod.BACKENDS, "gym", factory)
    out = str(tmp_path / "lrs")
    args = ["sweep", "--config", os.path.join(CONFIGS, "lr_sweep.yaml"),
            "--output-dir", out, "--device", "cpu",
            "--set", "sweep.steps=2"]
    assert cli_main(args + ["--report-only"]) == 2
    assert "no sweep records" in capsys.readouterr().err
    assert cli_main(args + ["--max-trials", "2"]) == 0
    assert len(calls) == 2 and len(load_records(out)) == 2
    with open(os.path.join(out, "spec.json")) as f:
        assert json.load(f)["steps"] == 2
    assert cli_main(args) == 1             # the rest: two trials fail
    assert len(calls) == 6
    capsys.readouterr()
    assert cli_main(args + ["--retry-failed"]) == 1   # the transient one
    assert calls[-1] == (0.001, 0) and len(calls) == 7
    text = capsys.readouterr().out
    assert "best trial: lr=0.001__weight_decay=0.1__seed=0" in text
    with open(os.path.join(out, "report.json")) as f:
        report = json.load(f)
    # the report reads every line of records.jsonl, the transient
    # failure's first record too, as JAX's does
    assert report["by_status"] == {"ok": 5, "failed": 2}
    assert report["failures_by_type"] == {"OSError (transient)": 1,
                                          "ValueError (deterministic)": 1}
    assert cli_main(args + ["--report-only"]) == 0
    assert cli_main(args + ["--redo"]) == 0
    assert len(calls) == 13 and len(load_records(out)) == 6
    assert os.path.exists(os.path.join(out, "resolved.yaml"))


def test_validate_reports_the_sweeps(capsys):
    rc = cli_main(["validate",
                   os.path.join(CONFIGS, "lr_sweep.yaml"),
                   os.path.join(CONFIGS, "ablation_dryrun.yaml")])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert lines[0].startswith("ok ") and lines[0].endswith(
        "(kind=sweep backend=gym trials=6)")
    assert lines[1].startswith("ok ") and lines[1].endswith(
        "(kind=sweep backend=dryrun trials=12)")


def test_sweep_shim_warns_and_delegates(capsys):
    from repro_torch.launch.sweep import main

    with pytest.warns(DeprecationWarning, match="repro_torch sweep"):
        rc = main(["--config", os.path.join(CONFIGS, "lr_sweep.yaml"),
                   "--list"])
    assert rc == 0 and "trials=6" in capsys.readouterr().out


def test_train_shim_warns_and_trains(tmp_path, monkeypatch, capsys):
    import tempfile

    from repro_torch.launch.train import main

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.warns(DeprecationWarning, match="repro_torch train"):
        rc = main(["--arch", "qwen1.5-0.5b", "--reduced", "--steps", "2",
                   "--seq-len", "32", "--global-batch", "4",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "done: 1 logged points; first loss" in out
    assert (tmp_path / "repro_train_qwen1p5_0p5b.tokens.u32").exists()
    with open(tmp_path / "results" / "runs" / "train_qwen1p5_0p5b" /
              "result.json") as f:
        assert json.load(f)["steps"] == 2
