"""The port's training loop and its input pipeline against the JAX package,
on the CPU: the synthetic dataset and the loader, the prefetch wrapper, the
gym's loss curve on the quickstart document from JAX's initial state, the
evaluator, telemetry, and the ``train`` kind of the run API and CLI with the
settings this slice refuses.

Tolerances: ``CURVE_TOL`` (2e-3 absolute on losses near 6.3) for the
10-step quickstart curve: each step's loss differs by bf16 rounding alone
(3e-4 at most in one step, ``tests/test_torch_train.py``) and the params,
updated by Adam from gradients that differ by that rounding, drift apart by
a few lr-sized steps; 5.3e-4 is the largest difference seen here.  The
evaluator's perplexity loss: the same bound as one step's loss, 3e-3 of the
loss.
"""
import copy
import os
import threading

import jax
import numpy as np
import pytest
import torch

from repro.config.resolver import resolve_config as jax_resolve_config
from repro.core.components import register_all as jax_register_all
from repro.core.evaluator import PerplexityEvaluator as JaxEvaluator
from repro.data import packed_dataset as JD
from repro_torch.bridge import params_from_jax
from repro_torch.config.resolver import load_yaml, resolve_config
from repro_torch.configs import get_reduced
from repro_torch.core.components import register_all
from repro_torch.core.evaluator import PerplexityEvaluator
from repro_torch.core.gym import Gym
from repro_torch.data import packed_dataset as PD
from repro_torch.data.prefetch import PrefetchLoader
from repro_torch.device import NoDeviceError
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.run import api
from repro_torch.run.cli import main as cli_main
from repro_torch.run.config import parse_run_doc
from repro_torch.run.overrides import apply_overrides, parse_overrides
from repro_torch.telemetry import TelemetryRecorder, validate_rows
from repro_torch.tree import tree_leaves

QUICKSTART = os.path.join(os.path.dirname(__file__), "..", "examples",
                          "configs", "quickstart.yaml")
CURVE_TOL = 2e-3
EVAL_TOL = 3e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are reduced: their ops are far too small to split
    across threads, and under the suite's parallel workers, which share the
    host's cores, torch's default of one thread per core leaves each op
    waiting on descheduled threads.  One thread for this module, restored
    after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(_msg):
    pass


def _doc(tmp_path, *sets):
    doc = load_yaml(QUICKSTART)
    return apply_overrides(doc, parse_overrides(
        [f"dataset.config.prefix={tmp_path / 'qs'}",
         f"run.output_dir={tmp_path / 'out'}", *sets]))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
def test_synthetic_dataset_files_equal_jax(tmp_path):
    JD.synthetic_dataset(30000, 512, str(tmp_path / "jax"), seed=3)
    PD.synthetic_dataset(30000, 512, str(tmp_path / "port"), seed=3)
    for suffix in (".tokens.u32", ".docidx.npy"):
        with open(tmp_path / f"jax{suffix}", "rb") as a, \
                open(tmp_path / f"port{suffix}", "rb") as b:
            assert a.read() == b.read()


def test_synthetic_dataset_appears_whole_to_ranks_writing_it_at_once(
        tmp_path):
    """The ranks of one run write its synthetic dataset at once: a rank
    that finds only another's partial tokens (no doc index yet) writes the
    dataset itself instead of reading the missing index, each file moves
    into place whole, and no temporary file is left."""
    from repro_torch.core import components as C

    prefix = str(tmp_path / "d")
    PD.synthetic_dataset(30000, 512, prefix + "_whole", seed=3)
    with open(prefix + ".tokens.u32", "wb") as f:
        f.write(b"\0" * 8)
    ds = C._synthetic_chunked(30000, 512, prefix, 32, seed=3)
    assert len(ds) > 0
    for suffix in (".tokens.u32", ".docidx.npy"):
        with open(prefix + suffix, "rb") as a, \
                open(prefix + "_whole" + suffix, "rb") as b:
            assert a.read() == b.read()
    assert sorted(os.listdir(tmp_path)) == sorted(
        p + s for p in ("d", "d_whole") for s in (".tokens.u32",
                                                  ".docidx.npy"))


def test_sharded_loader_batches_equal_jax(tmp_path):
    PD.synthetic_dataset(30000, 512, str(tmp_path / "d"), seed=4)
    jl = JD.ShardedLoader(JD.ChunkedLMDataset(
        JD.PackedDataset(str(tmp_path / "d")), 32, seed=1), 8, dp_rank=1,
        dp_size=2)
    pl = PD.ShardedLoader(PD.ChunkedLMDataset(
        PD.PackedDataset(str(tmp_path / "d")), 32, seed=1), 8, dp_rank=1,
        dp_size=2)
    for a, b in zip(jl.batches(5, start_step=7), pl.batches(5, start_step=7)):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


@pytest.fixture
def loader(tmp_path):
    PD.synthetic_dataset(20000, 97, str(tmp_path / "p"), seed=7)
    return PD.ShardedLoader(PD.ChunkedLMDataset(
        PD.PackedDataset(str(tmp_path / "p")), 16), global_batch=4)


@pytest.mark.parametrize("depth,to_device", [(0, True), (3, True), (2, False)])
def test_prefetch_loader_yields_the_inner_batches_in_order(loader, depth,
                                                          to_device):
    want = list(loader.batches(6, start_step=2))
    got = list(PrefetchLoader(loader, depth=depth, to_device=to_device,
                              device=torch.device("cpu")).batches(
        6, start_step=2))
    assert len(got) == len(want)
    for a, b in zip(want, got):
        for k in a:
            if to_device:
                assert isinstance(b[k], torch.Tensor) and b[k].device.type == "cpu"
            assert np.array_equal(a[k], np.asarray(b[k]))


def test_prefetch_loader_stops_an_abandoned_worker(loader):
    before = {t.ident for t in threading.enumerate()}
    it = PrefetchLoader(loader, depth=2, device=torch.device("cpu")).batches(
        1000)
    next(it)
    workers = [t for t in threading.enumerate()
               if t.name == "repro-torch-prefetch" and t.ident not in before]
    assert len(workers) == 1
    it.close()
    workers[0].join(timeout=5.0)
    assert not workers[0].is_alive()


def test_prefetch_loader_needs_a_device(loader):
    with pytest.raises(ValueError, match="no device"):
        next(PrefetchLoader(loader, depth=1).batches(1))


# ---------------------------------------------------------------------------
# the gym
# ---------------------------------------------------------------------------
def test_quickstart_curve_matches_jax_gym(tmp_path):
    """10 steps of the quickstart document from JAX's initial state: JAX's
    gym against the port's, on the same dataset files."""
    doc = _doc(tmp_path)
    graph = {k: v for k, v in doc.items() if k != "run"}
    jax_register_all()
    register_all()
    jgym = jax_resolve_config(copy.deepcopy(graph))["gym"]
    jstate = jgym.setup()
    params = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    jstate["params"]))
    jout = jgym.run(10, state=jstate)
    gym = resolve_config(copy.deepcopy(graph))["gym"]
    gym.device = "cpu"
    gym.setup()
    state = {"params": params, "opt": gym.optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    out = gym.run(10, state=state)
    want = [h["loss"] for h in jout["history"]]
    got = [h["loss"] for h in out["history"]]
    assert [h["step"] for h in out["history"]] == list(range(1, 11))
    np.testing.assert_allclose(got, want, atol=CURVE_TOL, rtol=0)
    assert out["steps_dispatched"] == out["productive_steps"] == 10


def test_gym_flushes_once_per_window_one_window_late(loader):
    """log_every=3: metric rows at steps 1, 3, 6, 9; each window's metrics
    are fetched when the next window is stashed (and the last at the end),
    with one device-to-host copy per window."""
    model = build_model(get_reduced("qwen1p5_0p5b").with_(remat="none"))
    rec = TelemetryRecorder(run="t", kind="train")
    flushed = []
    gym = Gym(model=model, optimizer=AdamW(lr=1e-3), loader=loader,
              log_every=3, prefetch=2, device="cpu", telemetry=rec,
              logger=lambda m: flushed.append((m["step"], len(calls))))
    calls = []
    state = gym.setup()
    step = gym._step

    def counting(s, b):
        calls.append(1)
        return step(s, b)

    gym._step = counting
    out = gym.run(9, state=state)
    assert [h["step"] for h in out["history"]] == [1, 3, 6, 9]
    # step 1's metrics were fetched after step 3 was issued, step 3's after 6
    assert flushed == [(1, 3), (3, 6), (6, 9), (9, 9)]
    assert validate_rows(rec.rows) == len(rec.rows)
    spans = [r["name"] for r in rec.rows if r["type"] == "span"]
    assert spans.count("gym/step") == spans.count("gym/data_wait") == 9
    assert spans.count("gym/flush") == 4
    assert int(out["state"]["step"]) == 9


def _mamba2_gym(loader, **kw):
    return Gym(model=build_model(get_reduced("mamba2_780m")),
               optimizer=AdamW(lr=1e-3), loader=loader, log_every=2,
               prefetch=2, device="cpu", **kw)


def test_gym_marks_the_phases_of_each_step(loader):
    """3 steps of reduced Mamba2 with a recorder: each ``gym/step`` holds
    one ``step/forward``, ``step/backward`` and ``step/optimizer``, in that
    order, disjoint and inside it, and each backward one
    ``step/ssd_backward`` per layer; the run's entry and exit are spans;
    on the CPU no ``device/*`` row."""
    rec = TelemetryRecorder(run="t", kind="train")
    gym = _mamba2_gym(loader, telemetry=rec)
    gym.run(3, state=gym.setup())
    assert validate_rows(rec.rows) == len(rec.rows)
    spans = [r for r in rec.rows if r["type"] == "span"]
    assert not [r for r in spans if r["name"].startswith("device/")]
    by_id = {r["span_id"]: r for r in spans}
    steps = [r for r in spans if r["name"] == "gym/step"]
    assert [r["step"] for r in steps] == [1, 2, 3]
    n_layers = gym.model.cfg.n_layers
    for st in steps:
        kids = sorted((r for r in spans if r["parent_id"] == st["span_id"]),
                      key=lambda r: r["t0_s"])
        assert [r["name"] for r in kids] == ["step/forward", "step/backward",
                                             "step/optimizer"]
        assert all(r["step"] == st["step"] and r["depth"] == 1 for r in kids)
        assert st["t0_s"] <= kids[0]["t0_s"] and kids[-1]["t1_s"] <= st["t1_s"]
        for a, b in zip(kids, kids[1:]):
            assert a["t0_s"] <= a["t1_s"] <= b["t0_s"] <= b["t1_s"]
        bwd = kids[1]
        ssd = [r for r in spans if r["name"] == "step/ssd_backward"
               and r["step"] == st["step"]]
        assert len(ssd) == n_layers
        for r in ssd:
            assert by_id[r["parent_id"]] is bwd and r["depth"] == 2
            assert bwd["t0_s"] <= r["t0_s"] <= r["t1_s"] <= bwd["t1_s"]
    enter, = [r for r in spans if r["name"] == "gym/run_enter"]
    leave, = [r for r in spans if r["name"] == "gym/run_exit"]
    assert enter["t1_s"] <= steps[0]["t0_s"] and steps[-1]["t1_s"] <= \
        leave["t0_s"] and (enter["step"], leave["step"]) == (1, 3)


def test_gym_marks_the_exchange_under_a_mesh(loader):
    """Under ``ddp`` on a one-rank gloo mesh each ``gym/step`` holds one
    ``step/exchange`` (``laid_out``'s redistribution), between its
    backward and its optimizer; on the CPU still no ``device/*`` row."""
    from repro_torch.launch import mesh as MESH
    from repro_torch.sharding import plans as PL

    mesh = MESH.make_local_mesh(1, 1, device_type="cpu")
    try:
        rec = TelemetryRecorder(run="t", kind="train")
        gym = _mamba2_gym(loader, telemetry=rec, mesh=mesh,
                          plan=PL.make_plan("ddp"))
        gym.run(2, state=gym.setup())
    finally:
        MESH.shutdown()
    assert validate_rows(rec.rows) == len(rec.rows)
    spans = [r for r in rec.rows if r["type"] == "span"]
    assert not [r for r in spans if r["name"].startswith("device/")]
    steps = [r for r in spans if r["name"] == "gym/step"]
    assert [r["step"] for r in steps] == [1, 2]
    for st in steps:
        kids = sorted((r for r in spans if r["parent_id"] == st["span_id"]),
                      key=lambda r: r["t0_s"])
        assert [r["name"] for r in kids] == [
            "step/forward", "step/backward", "step/exchange",
            "step/optimizer"]
        for a, b in zip(kids, kids[1:]):
            assert a["t0_s"] <= a["t1_s"] <= b["t0_s"] <= b["t1_s"]


def test_gym_phases_leave_the_steps_bit_equal(loader):
    """Losses and params after 3 steps with the phases recorded ``==``
    those with no recorder."""
    outs = []
    for rec in (TelemetryRecorder(run="t", kind="train"), None):
        gym = _mamba2_gym(loader, telemetry=rec)
        outs.append(gym.run(3, state=gym.setup()))
    on, off = outs
    assert [h["loss"] for h in on["history"]] == \
        [h["loss"] for h in off["history"]]
    a, b = (tree_leaves(o["state"]["params"]) for o in outs)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_perplexity_evaluator_matches_jax(tmp_path):
    PD.synthetic_dataset(20000, 512, str(tmp_path / "e"), seed=2)
    jds = JD.ChunkedLMDataset(JD.PackedDataset(str(tmp_path / "e")), 32)
    pds = PD.ChunkedLMDataset(PD.PackedDataset(str(tmp_path / "e")), 32)
    from repro.configs import get_reduced as jax_get_reduced
    from repro.models import build_model as jax_build_model

    jm = jax_build_model(jax_get_reduced("qwen1p5_0p5b"))
    jparams = jm.init(jax.random.PRNGKey(0))
    want = JaxEvaluator(jds, n_samples=6, batch=4)(jm, jparams)
    pm = build_model(get_reduced("qwen1p5_0p5b"))
    ev = PerplexityEvaluator(pds, n_samples=6, batch=4)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    got = ev(pm, params)
    assert ev._loss_fn(pm) is ev._loss_fn(pm)      # built once per model
    assert abs(got["loss"] - want["loss"]) <= EVAL_TOL * want["loss"]
    assert abs(got["ppl"] - want["ppl"]) <= 2 * EVAL_TOL * want["ppl"]


# ---------------------------------------------------------------------------
# the run API and the CLI
# ---------------------------------------------------------------------------
def test_cli_trains_the_quickstart_on_the_cpu(tmp_path, capsys):
    rc = cli_main(["train", "--config", QUICKSTART, "--device", "cpu",
                   "--set", "run.train.steps=12",
                   "--set", f"dataset.config.prefix={tmp_path / 'qs'}",
                   "--set", f"run.output_dir={tmp_path / 'out'}"])
    assert rc == 0
    assert "done: 12 logged points; first loss" in capsys.readouterr().out
    import json

    with open(tmp_path / "out" / "result.json") as f:
        result = json.load(f)
    assert result["goodput"] == 1.0 and result["tokens_per_s"] > 0
    assert len(result["history"]) == 12
    assert np.isfinite([result["first_loss"], result["final_loss"]]).all()
    from repro_torch.telemetry import read_jsonl

    rows = read_jsonl(str(tmp_path / "out" / "telemetry.jsonl"))
    # the gym's spans and the phases of the (attention) step; on the CPU
    # no device/* row
    assert {r["name"] for r in rows if r["type"] == "span"} == \
        {"gym/run_enter", "gym/data_wait", "gym/step", "gym/flush",
         "gym/run_exit", "step/forward", "step/backward", "step/optimizer"}


def test_train_without_device_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the run would train on it")
    with pytest.raises(NoDeviceError):
        api.execute_doc(_doc(tmp_path, "run.train.steps=1"), log=_quiet)


REFUSED = [
    # dryrun and trace are ported: a train document relabelled as either
    # fails as in JAX, for want of a shape, or for its train settings
    ("run={kind: dryrun}", "^dryrun run needs a top-level 'shape' entry"),
    ("run.kind=dryrun", "^run section has unknown keys \\['train'\\]"),
    ("run.kind=trace", "^run section has unknown keys \\['train'\\]"),
    # sweeps are ported: this document now parses as a sweep, whose body
    # (a train graph) is no sweep spec (see the test)
    ("run.kind=sweep", "^sweep$"),
    # a plan with no mesh, or a single_device mesh, trains unsharded as in
    # JAX since A8a: those cases are in tests/test_torch_mesh_train.py
    # the encoder-decoder is ported, but the loader yields no frames: the
    # train kind refuses it before its first step
    ("arch.variant_key=whisper_tiny", "^train: .*'frames'"),
]


@pytest.mark.parametrize("setting,slice_", REFUSED,
                         ids=[s.split("=")[0] + "=" + s.split("=")[1][:12]
                              for s, _ in REFUSED])
def test_settings_of_later_slices_are_refused(tmp_path, setting, slice_):
    from repro_torch.run.config import RunError, parse_run_doc
    from repro_torch.sweep.spec import SweepError

    doc = _doc(tmp_path, "run.train.steps=1", setting)
    if slice_ == "^sweep$":
        # (without the train settings, which a sweep refuses as JAX's does)
        doc["run"].pop("train")
        assert parse_run_doc(doc).kind == "sweep"
        with pytest.raises(SweepError, match="unknown sweep keys"):
            api.execute_doc(doc, device="cpu", log=_quiet)
        return
    err = RunError if slice_.startswith("^") else NotImplementedError
    with pytest.raises(err, match=slice_):
        api.execute_doc(doc, device="cpu", log=_quiet)


def test_train_document_parses_with_its_telemetry_block():
    cfg = parse_run_doc(load_yaml(QUICKSTART), kind="train")
    assert cfg.settings.steps == 60 and cfg.settings.telemetry.spans
    assert cfg.settings.telemetry.sink == "jsonl"
    assert not parse_run_doc({"run": {"kind": "train", "train": {
        "telemetry": False}}}).settings.telemetry.enabled


def test_train_result_keys(tmp_path):
    """The result keys of JAX's train kind, ``mfu`` and the resilience
    record included (``tests/test_torch_telemetry.py`` holds their values
    against JAX)."""
    res = api.execute_doc(_doc(tmp_path, "run.train.steps=3"), device="cpu",
                          log=_quiet)
    for key in ("first_loss", "final_loss", "tokens_per_s", "goodput",
                "history", "steps_dispatched", "telemetry", "mfu",
                "model_flops_per_step", "rollback_count", "retry_count",
                "graceful_exit"):
        assert key in res, key
    assert res["steps_dispatched"] == 3 and res["logged_points"] == 3
