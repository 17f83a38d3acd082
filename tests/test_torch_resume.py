"""Resume, warmstart and serving from a checkpoint in the port's gym and run
API, on the CPU (the cases of ``tests/test_ckpt.py`` and
``tests/test_checkpoint.py`` that drive a gym, held to ``==``), and a JAX
run resumed by the port.

The port's train step is deterministic on the CPU, so an interrupted and
resumed run must equal the straight one exactly (losses and params), not
within JAX's 1e-6.  The JAX-to-port resume compares the port's resumed
steps with JAX's straight run within ``CURVE_TOL`` of
``tests/test_torch_gym.py`` (the two packages round bf16 activations at
other places; see that file).
"""
import json
import os
import shutil
import warnings
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.run import api as jax_api
from repro_torch.ckpt import (AsyncCheckpointer, LossyCastWarning,
                              RestoreError, list_checkpoints, read_manifest,
                              write_checkpoint)
from repro_torch.ckpt import format as CF
from repro_torch.config.resolver import load_yaml
from repro_torch.configs import get_reduced
from repro_torch.core.gym import Gym
from repro_torch.data import packed_dataset as PD
from repro_torch.device import NoDeviceError
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.run import api
from repro_torch.run.api import _apply_warmstart
from repro_torch.run.cli import main as cli_main
from repro_torch.run.config import (RunError, TrainSettings,
                                    WarmstartSettings)
from repro_torch.run.overrides import apply_overrides, parse_overrides
from repro_torch.serve.engine import load_params
from repro_torch.train import checkpoint as CK
from repro_torch.train import steps as ST

ROOT = os.path.join(os.path.dirname(__file__), "..")
QUICKSTART = os.path.join(ROOT, "examples", "configs", "quickstart.yaml")
WARMSTART = os.path.join(ROOT, "examples", "configs", "warmstart.yaml")
CURVE_TOL = 2e-3    # tests/test_torch_gym.py


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


def _assert_trees_equal(a, b):
    fa, fb = CF.flatten_with_paths(a), CF.flatten_with_paths(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x, y), k


def _tiny(tmp_path, master_weights=False):
    model = build_model(get_reduced("qwen1p5_0p5b").with_(n_layers=1))
    opt = AdamW(lr=1e-3, master_weights=master_weights)
    PD.synthetic_dataset(40000, 512, str(tmp_path / "data"), seed=2)
    loader = PD.ShardedLoader(PD.ChunkedLMDataset(
        PD.PackedDataset(str(tmp_path / "data")), 32, seed=0), global_batch=4)
    return model, opt, loader


def _gym(model, opt, loader, **kw):
    kw.setdefault("log_every", 1)
    return Gym(model=model, optimizer=opt, loader=loader, prefetch=0,
               device="cpu", **kw)


def _losses(*outs):
    merged = {}
    for out in outs:
        merged.update({m["step"]: m["loss"] for m in out["history"]})
    return merged


# ---------------------------------------------------------------------------
# the gym
# ---------------------------------------------------------------------------
def test_gym_async_ckpt_and_resume_matches_straight(tmp_path):
    """Train 6 straight == train 4 (async checkpoints), restore, train to 6:
    losses and final params ``==``."""
    model, opt, loader = _tiny(tmp_path)
    d = str(tmp_path / "ck")
    g = _gym(model, opt, loader)
    straight = g.run(6, state=g.setup())

    g_a = _gym(model, opt, loader, ckpt_every=2, ckpt_dir=d)
    part = g_a.run(4, state=g_a.setup())
    assert [s for s, _ in list_checkpoints(d)] == [2, 4]
    assert g_a.checkpointer._worker is None          # closed with the run

    g_b = _gym(model, opt, loader, ckpt_every=2, ckpt_dir=d)
    state_b, step = g_b.restore(g_b.setup())
    assert step == 4 and state_b["step"].dtype == torch.int32
    _assert_trees_equal(state_b, part["state"])
    resumed = g_b.run(2, state=state_b)
    assert _losses(part, resumed) == _losses(straight)
    _assert_trees_equal(resumed["state"], straight["state"])


def test_gym_ckpt_span_and_manifest_fingerprint(tmp_path):
    from repro_torch.telemetry import TelemetryRecorder

    model, opt, loader = _tiny(tmp_path)
    rec = TelemetryRecorder(run="t", kind="train")
    g = _gym(model, opt, loader, ckpt_every=2, ckpt_dir=str(tmp_path / "c"),
             run_fingerprint="sha256:aaaa", telemetry=rec)
    g.run(4, state=g.setup())
    spans = [r for r in rec.rows if r["type"] == "span"
             and r["name"] == "gym/ckpt"]
    assert [r["step"] for r in spans] == [2, 4]
    man = read_manifest(str(tmp_path / "c" / "step_00000004"))
    assert man["fingerprint"] == "sha256:aaaa" and man["n_leaves"] == 44


def test_resume_is_deterministic(tmp_path):
    """Train 6 steps straight == train 3, legacy checkpoint, restore, train
    3 (``tests/test_checkpoint.py``), with ``==``."""
    model, opt, loader = _tiny(tmp_path)
    step = ST.make_train_step(model, opt)

    def fresh():
        return ST.init_train_state(model, opt, torch.Generator().manual_seed(0))

    s = fresh()
    for batch in loader.batches(6):
        s, _ = step(s, {k: torch.from_numpy(v) for k, v in batch.items()})
    straight = s

    s = fresh()
    for batch in loader.batches(3):
        s, _ = step(s, {k: torch.from_numpy(v) for k, v in batch.items()})
    path = CK.save_checkpoint(s, str(tmp_path / "ck2"), 3)
    s2 = CK.restore_checkpoint(fresh(), path)
    for batch in loader.batches(3, start_step=3):
        s2, _ = step(s2, {k: torch.from_numpy(v) for k, v in batch.items()})
    _assert_trees_equal(s2, straight)


def test_gym_restore_warns_on_fingerprint_mismatch(tmp_path):
    model, opt, loader = _tiny(tmp_path)
    d = str(tmp_path / "ck")
    g_a = _gym(model, opt, loader, log_every=0, ckpt_every=1, ckpt_dir=d,
               run_fingerprint="sha256:aaaa")
    g_a.run(1, state=g_a.setup())
    g_b = _gym(model, opt, loader, ckpt_dir=d, run_fingerprint="sha256:bbbb")
    with pytest.warns(UserWarning, match="fingerprint"):
        _, step = g_b.restore(g_b.setup())
    assert step == 1
    g_c = _gym(model, opt, loader, ckpt_dir=d, run_fingerprint="sha256:aaaa")
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        _, step = g_c.restore(g_c.setup())
    assert step == 1


def test_gym_restore_without_checkpoint_is_noop(tmp_path):
    model, opt, loader = _tiny(tmp_path)
    g = _gym(model, opt, loader, ckpt_dir=str(tmp_path / "nothing"))
    s0 = g.setup()
    s1, step = g.restore(s0)
    assert step is None and s1 is s0


# ---------------------------------------------------------------------------
# the run API
# ---------------------------------------------------------------------------
def _tiny_doc(tmp_path, name, steps, **train):
    doc = apply_overrides(load_yaml(QUICKSTART), parse_overrides([
        f"run.name={name}", f"run.output_dir={tmp_path / name}",
        f"run.train.steps={steps}", "run.train.telemetry=false",
        "arch.config.n_layers=1", "variables.seq_len=32",
        "loader.config.global_batch=4", "dataset.config.n_tokens=40000",
        f"dataset.config.prefix={tmp_path / 'data'}",
        "gym.config.prefetch=0", "gym.config.ckpt_every=2"]))
    doc["run"]["train"].update(train)
    return doc


def test_run_api_resume_auto_total_budget(tmp_path):
    base = api.execute_doc(_tiny_doc(tmp_path, "base", 6), device="cpu",
                           log=_quiet)
    part = api.execute_doc(_tiny_doc(tmp_path, "trial", 4), device="cpu",
                           write_result=True, log=_quiet)
    assert [s for s, _ in list_checkpoints(str(tmp_path / "trial" / "ckpt"))] \
        == [2, 4]
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        res = api.execute_doc(_tiny_doc(tmp_path, "trial", 6, resume="auto"),
                              device="cpu", write_result=True, log=_quiet)
    assert not [w for w in rec if "fingerprint" in str(w.message)]
    assert res["resumed_from"] == 4 and res["steps_this_run"] == 2
    assert _losses(part, res) == _losses(base)

    # a resume under a CHANGED component graph warns
    changed = _tiny_doc(tmp_path, "trial", 6, resume="auto")
    changed["optimizer"]["config"]["lr"] = 0.01
    with pytest.warns(UserWarning, match="fingerprint"):
        api.execute_doc(changed, device="cpu", log=_quiet)

    # a complete run resumes to a no-op and keeps its result.json
    res2 = api.execute_doc(_tiny_doc(tmp_path, "trial", 6, resume="auto"),
                           device="cpu", write_result=True, log=_quiet)
    assert res2["resumed_from"] == 6 and res2["steps_this_run"] == 0
    with open(tmp_path / "trial" / "result.json") as f:
        on_disk = json.load(f)
    assert on_disk["history"][-1]["step"] == 6


def test_resume_auto_without_ckpt_every_on_resume_invocation(tmp_path):
    api.execute_doc(_tiny_doc(tmp_path, "trial2", 4), device="cpu",
                    log=_quiet)
    doc = _tiny_doc(tmp_path, "trial2", 6, resume="auto")
    del doc["gym"]["config"]["ckpt_every"]
    res = api.execute_doc(doc, device="cpu", log=_quiet)
    assert res["resumed_from"] == 4 and res["steps_this_run"] == 2


def test_run_api_warmstart_kinds(tmp_path):
    donor = api.execute_doc(_tiny_doc(tmp_path, "donor", 4), device="cpu",
                            log=_quiet)
    src = str(tmp_path / "donor" / "ckpt")
    fresh = api.execute_doc(_tiny_doc(tmp_path, "fresh", 1), device="cpu",
                            log=_quiet)
    r = api.execute_doc(_tiny_doc(
        tmp_path, "warm", 2, warmstart={"source": src, "optimizer": "fresh"}),
        device="cpu", log=_quiet)
    assert r["warmstart"]["source"] == src and "resumed_from" not in r
    # params came from a trained checkpoint: loss starts below fresh init
    assert r["first_loss"] < fresh["first_loss"]
    assert donor["final_loss"] < fresh["first_loss"]

    kind_doc = _tiny_doc(tmp_path, "warm2", 2)
    kind_doc["run"] = {"kind": "warmstart", "name": "warm2",
                       "output_dir": str(tmp_path / "warm2"),
                       "warmstart": {"source": src, "steps": 2,
                                     "optimizer": "carry"}}
    r2 = api.execute_doc(kind_doc, device="cpu", log=_quiet)
    assert r2["kind"] == "warmstart" and r2["first_loss"] < fresh["first_loss"]


def _master_state(w_params, master):
    return {"params": {"w": w_params},
            "opt": {"m": {"w": torch.zeros(4)}, "v": {"w": torch.zeros(4)},
                    "count": torch.tensor(0, dtype=torch.int32),
                    "master": {"w": master}},
            "step": torch.tensor(0, dtype=torch.int32)}


def test_carry_warmstart_restores_masters_jointly_no_warning(tmp_path):
    w = torch.linspace(0, 1, 4)
    path = write_checkpoint(str(tmp_path), 1, dict(CF.flatten_with_paths(
        {"params": {"w": w},
         "opt": {"m": {"w": torch.zeros(4)}, "v": {"w": torch.zeros(4)},
                 "count": torch.tensor(3, dtype=torch.int32),
                 "master": {"w": w}}})))
    cfg = SimpleNamespace(config_dir=".")
    with warnings.catch_warnings():
        warnings.simplefilter("error", LossyCastWarning)
        out = _apply_warmstart(
            _master_state(torch.zeros(4, dtype=torch.bfloat16),
                                torch.zeros(4)),
            WarmstartSettings(source=path, optimizer="carry"), cfg, _quiet)
    assert torch.equal(out["opt"]["master"]["w"], w)
    assert int(out["opt"]["count"]) == 3
    assert out["params"]["w"].dtype == torch.bfloat16

    # a donor WITHOUT masters: the target's masters are rebased onto the
    # restored params, not left at random init (and exempt from strict)
    path2 = write_checkpoint(str(tmp_path / "nomaster"), 1, dict(
        CF.flatten_with_paths(
            {"params": {"w": w},
             "opt": {"m": {"w": torch.zeros(4)}, "v": {"w": torch.zeros(4)},
                     "count": torch.tensor(5, dtype=torch.int32)}})))
    out2 = _apply_warmstart(
        _master_state(torch.zeros(4), torch.full((4,), -7.0)),
        WarmstartSettings(source=path2, optimizer="carry"), cfg, _quiet)
    assert torch.equal(out2["opt"]["master"]["w"], w)
    assert out2["opt"]["master"]["w"] is not out2["params"]["w"]
    assert int(out2["opt"]["count"]) == 5


def test_fresh_warmstart_rebases_master_weights(tmp_path):
    trained = torch.linspace(3, 4, 4)
    path = write_checkpoint(str(tmp_path), 1, {"params/w": trained})
    with pytest.warns(LossyCastWarning):      # fresh DOES discard the masters
        out = _apply_warmstart(
            _master_state(torch.zeros(4, dtype=torch.bfloat16),
                                torch.full((4,), -7.0)),
            WarmstartSettings(source=path, optimizer="fresh"),
            SimpleNamespace(config_dir="."), _quiet)
    assert torch.equal(out["opt"]["master"]["w"], out["params"]["w"].float())
    assert int(out["opt"]["count"]) == 0


def test_warmstart_from_adapter_checkpoint_is_refused(tmp_path):
    """An adapter-only checkpoint cannot warmstart a base model strictly:
    it has no base leaves (a full checkpoint with adapters warmstarts a
    LoRA run: ``tests/test_torch_posttrain.py``)."""
    path = write_checkpoint(str(tmp_path), 1, {"params/lora/a": torch.ones(2)})
    with pytest.raises(RestoreError, match="params/w"):
        _apply_warmstart({"params": {"w": torch.zeros(2)}},
                         WarmstartSettings(source=path),
                         SimpleNamespace(config_dir="."), _quiet)


def test_train_settings_validation():
    with pytest.raises(RunError, match="resume"):
        TrainSettings(resume="latest")
    with pytest.raises(RunError, match="source"):
        TrainSettings(warmstart={})
    with pytest.raises(RunError, match="fresh|carry"):
        TrainSettings(warmstart={"source": "x", "optimizer": "maybe"})
    with pytest.raises(RunError, match="mutually"):
        TrainSettings(resume="auto", warmstart={"source": "x"})
    with pytest.raises(RunError, match="unknown keys"):
        TrainSettings(warmstart={"source": "x", "mesh": 1})
    assert TrainSettings(resume="auto").resume == "auto"
    assert TrainSettings(resilience={"sentinel": True}).resilience \
        .sentinel.metric == "loss"


# ---------------------------------------------------------------------------
# JAX run, port resume
# ---------------------------------------------------------------------------
def test_port_resumes_a_jax_run(tmp_path):
    """JAX trains 4 steps of a tiny document, checkpointing every 2; the
    port resumes from JAX's step-2 checkpoint with ``resume: auto`` (the
    same component graph, so no fingerprint warning) and its steps 3-4
    follow JAX's straight run within CURVE_TOL."""
    jax_doc = _tiny_doc(tmp_path, "jax", 4)
    jres = jax_api.execute_doc(jax_doc)
    jdir = str(tmp_path / "jax" / "ckpt")
    assert [s for s, _ in list_checkpoints(jdir)] == [2, 4]
    os.makedirs(tmp_path / "port" / "ckpt")
    shutil.copytree(f"{jdir}/step_00000002",
                    tmp_path / "port" / "ckpt" / "step_00000002")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        res = api.execute_doc(_tiny_doc(tmp_path, "port", 4, resume="auto"),
                              device="cpu", log=_quiet)
    assert not [w for w in rec if "fingerprint" in str(w.message)]
    assert res["resumed_from"] == 2
    want = {m["step"]: m["loss"] for m in jres["history"]}
    got = _losses(res)
    assert sorted(got) == [3, 4]
    np.testing.assert_allclose([got[3], got[4]], [want[3], want[4]],
                               atol=CURVE_TOL, rtol=0)


# ---------------------------------------------------------------------------
# serving from a checkpoint, the CLI, and the card default
# ---------------------------------------------------------------------------
def test_load_params_from_both_formats(tmp_path):
    model = build_model(get_reduced("qwen1p5_0p5b"))
    state = ST.init_train_state(model, AdamW(lr=1e-3),
                                torch.Generator().manual_seed(3))
    ck = AsyncCheckpointer(str(tmp_path / "sharded"), background=False)
    ck.save(state, 5)
    npz = CK.save_checkpoint(state, str(tmp_path / "legacy"), 5)
    bare = write_checkpoint(str(tmp_path / "bare"), 0, dict(
        CF.flatten_with_paths(state["params"])))
    for path in (str(tmp_path / "sharded"), npz, bare):
        got = load_params(model, ckpt=path, device="cpu")
        assert list(got) == list(state["params"])
        _assert_trees_equal(got, state["params"])


def test_cli_warmstart_document_runs_unchanged(tmp_path, capsys):
    """The two commands in ``warmstart.yaml``'s header, on the CPU, both
    pointed at ``tmp_path``: the donor checkpoints at step 20, the
    unchanged warmstart document trains its 40 steps from it and
    checkpoints at 20 and 40 in its own run dir."""
    data = f"dataset.config.prefix={tmp_path / 'qs'}"
    rc = cli_main(["train", "--config", QUICKSTART, "--device", "cpu",
                   "--set", "gym.config.ckpt_every=20",
                   "--set", "run.train.steps=20", "--set", data,
                   "--set", f"run.output_dir={tmp_path / 'donor'}"])
    assert rc == 0
    rc = cli_main(["warmstart", "--config", WARMSTART, "--device", "cpu",
                   "--source", str(tmp_path / "donor" / "ckpt"),
                   "--set", data,
                   "--set", f"run.output_dir={tmp_path / 'warm'}"])
    out = capsys.readouterr().out
    assert rc == 0 and "done: 40 logged points" in out
    with open(tmp_path / "warm" / "result.json") as f:
        result = json.load(f)
    assert result["kind"] == "warmstart"
    assert result["warmstart"]["optimizer"] == "fresh"
    assert np.isfinite([h["loss"] for h in result["history"]]).all()
    assert [s for s, _ in list_checkpoints(str(tmp_path / "warm" / "ckpt"))] \
        == [20, 40]


def test_entry_points_need_a_card_or_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is the card")
    model = build_model(get_reduced("qwen1p5_0p5b"))
    write_checkpoint(str(tmp_path / "ck"), 1, {"params/w": torch.zeros(2)})
    with pytest.raises(NoDeviceError):
        load_params(model, ckpt=str(tmp_path / "ck"))
    doc = _tiny_doc(tmp_path, "w", 1)
    doc["run"] = {"kind": "warmstart",
                  "warmstart": {"source": str(tmp_path / "ck")}}
    with pytest.raises(NoDeviceError):
        api.execute_doc(doc, log=_quiet)
    api.execute_doc(_tiny_doc(tmp_path, "r", 1), device="cpu",
                    write_result=True, log=_quiet)
    with pytest.raises(NoDeviceError):
        api.replay(str(tmp_path / "r"), log=_quiet)
