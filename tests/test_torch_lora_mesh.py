"""Post-training under JAX's sharding plans (the first part of ROADMAP A8b's
remainder) on the CPU: LoRA training in the gym, the ``sft`` and ``dpo``
kinds, adapter checkpoints and the merged export, and the engine over a
``LoRAModel``, on reduced Qwen1.5-0.5B.

- World size 1, in this process (a one-rank gloo group on a
  ``FileStore``, as the card runs a plan):
  - JAX's ``tests/test_posttrain.py::test_lora_merge_bitwise_under_sharded_plan``
    in the port: LoRA rank 4, ``fsdp``, 2 gym steps from JAX's params;
    ``lm.apply(params) == base.apply(lm.merge(params))`` bitwise, and the
    losses within ``CURVE_TOL`` (``tests/test_torch_posttrain.py``: bf16
    rounding over a few steps) of JAX's same run;
  - the ``sft`` kind under ``fsdp_tp`` ``==`` the run with no mesh: the
    losses, the adapter checkpoint's files and the merged export; and
    warmstarted from a checkpoint of the base alone (the adapters keep
    their fresh init);
  - the ``dpo`` kind under ``fsdp`` with on-policy pairs ``==`` the run
    with no mesh (the pairs sampled by an engine with no mesh on the
    gathered merged params), its first loss ``log 2``;
  - the engine over the LoRA model under ``fsdp_tp`` ``==`` the engine
    over the base model with ``merge(params)``, with no mesh.
- 4 gloo ranks, one ``torchrun`` launch on a ``(2, 2)`` mesh, f32
  activations (``ranks``):
  - the ``sft`` kind under ``ddp``, ``fsdp`` and ``fsdp_tp``: each loss
    within ``LOSS_TOL`` (A8a's, ``tests/test_torch_mesh_train.py``) of the
    run with no mesh, and the final checkpoint's base leaves ``==`` their
    init (gathered from every rank's blocks);
  - the ``dpo`` kind under ``fsdp_tp`` on static pairs (the engine's bf16
    cache takes no f32 activations): each loss within ``DPO_LOSS_TOL``
    (``tests/test_torch_dpo.py``) of the run with no mesh;
  - the adapter checkpoint written under ``fsdp_tp`` equals its gym
    checkpoint's adapters, restores on every rank under ``ddp`` through
    ``load_adapter(shardings=)``, and the gym checkpoint restores under
    ``ddp``, ``==``;
  - the engine over the LoRA model under ``fsdp_tp`` draws on every rank
    the streams of the engine over ``merge(params)`` with no mesh, or
    parts at a near-tie of the latter's logits (ROADMAP C2).
"""
import copy
import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.core.gym import Gym as JaxGym
from repro.data.packed_dataset import ShardedLoader as JaxShardedLoader
from repro.launch import mesh as JMESH
from repro.models import build_model as jax_build_model
from repro.optim.adamw import AdamW as JaxAdamW
from repro.posttrain import lora as JLO
from repro.posttrain.sft import PackedSFTDataset as JaxPackedSFTDataset
from repro.posttrain.sft import synthetic_sft_examples as jax_sft_examples
from repro.sharding.plans import make_plan as jax_make_plan
from repro_torch.bridge import params_from_jax
from repro_torch.ckpt import elastic as EL
from repro_torch.ckpt.format import flatten_with_paths, read_leaf
from repro_torch.config.resolver import load_yaml
from repro_torch.configs import get_reduced
from repro_torch.core.gym import Gym
from repro_torch.data.packed_dataset import ShardedLoader
from repro_torch.launch import mesh as MESH
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.posttrain import lora as LO
from repro_torch.posttrain.sft import PackedSFTDataset, synthetic_sft_examples
from repro_torch.run import api
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.workload import synthetic_trace
from repro_torch.sharding import plans as PL
from repro_torch.tree import tree_leaves, tree_map

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "examples",
                       "configs")
QWEN = "qwen1p5_0p5b"
CURVE_TOL = 2e-3        # tests/test_torch_posttrain.py
#: relative, f32 activations: a plan changes only the order of f32 sums
LOSS_TOL = 1e-5         # tests/test_torch_mesh_train.py
DPO_LOSS_TOL = 5e-3     # tests/test_torch_dpo.py
#: a near-tie in the logits of the engine's base model with no mesh
LOGIT_TOL = 3e-2        # tests/test_torch_engine.py
SFT_PLANS = ("ddp", "fsdp", "fsdp_tp")
STEPS = 2
TRACE = dict(n=4, seed=6, prompt_lens=(5, 7), gen_tokens=(5,),
             temperature=0.0, max_len=16)
ENGINE = dict(n_slots=2, max_len=16, block_len=0)
ONPOLICY = {"n_prompts": 2, "prompt_len": 6, "gen_tokens": 6,
            "temperature": 0.8, "n_slots": 2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Reduced models: one thread for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(_msg):
    pass


def _doc(kind, out, mesh=None, plan=None, onpolicy=False):
    """``examples/configs/{sft,dpo}.yaml``, cut to ``STEPS`` steps of
    sequence 32 from a fresh init, checkpointing its last step; under
    ``plan`` on a ``local`` mesh of ``mesh`` (dp, tp) where given; a
    ``dpo`` run on ``ONPOLICY``'s sampled pairs with ``onpolicy``."""
    doc = copy.deepcopy(load_yaml(os.path.join(CONFIGS, f"{kind}.yaml")))
    run = doc["run"]
    run["output_dir"] = out
    s = run[kind]
    s.pop("warmstart", None)
    s["steps"] = STEPS
    doc["variables"]["seq_len"] = 32
    doc["gym"]["config"]["ckpt_every"] = STEPS
    if kind == "sft":
        s["export_merged"] = True
    if onpolicy:
        s["onpolicy"] = dict(ONPOLICY)
    if plan is not None:
        dp, tp = mesh
        doc["mesh"] = {"component_key": "mesh_provider",
                       "variant_key": "local",
                       "config": {"dp": dp, "tp": tp}}
        doc["gym"]["config"]["mesh_provider"] = {"instance_key": "mesh"}
        doc["gym"]["config"]["sharding_plan"] = {
            "component_key": "sharding_plan", "variant_key": plan}
    return doc


def _losses(res):
    return [row["loss"] for row in res["history"]]


def _f32_activations():
    """The decoder's embeddings (and so its activations) in f32, for the
    multi-rank curves; returns the undo."""
    from repro_torch.models import transformer as TR

    embed = TR.DecoderLM.embed_tokens
    TR.DecoderLM.embed_tokens = (
        lambda self, p, t, dtype=None: embed(self, p, t, torch.float32))
    return lambda: setattr(TR.DecoderLM, "embed_tokens", embed)


def _lora_model():
    return LO.LoRAModel(build_model(get_reduced(QWEN)),
                        LO.LoRAConfig(rank=8))


def _ckpt_params(path):
    """``{key: tensor}`` of a checkpoint's ``params/...`` leaves."""
    from repro_torch.ckpt.format import read_manifest

    step = [d for d in sorted(os.listdir(path)) if d.startswith("step_")][-1]
    d = os.path.join(path, step)
    leaves = read_manifest(d)["leaves"]
    return {k[len("params/"):]: read_leaf(d, v) for k, v in leaves.items()
            if k.startswith("params/")}


def _trace():
    spec = dict(TRACE)
    n = spec.pop("n")
    return synthetic_trace(n, get_reduced(QWEN).vocab, **spec)


def _streams(model, params, **kw):
    res = ServeEngine(model, params, **ENGINE, **kw).run(
        _trace(), realtime=False, warmup=False)
    return [r["gen_ids"] for r in res["requests"]]


class _Launch:
    """A ``torchrun`` of 4 ranks started at once, its output in files (a
    pipe left unread could fill and stall it); ``result`` waits for it and
    reads rank 0's ``ranks.json``."""

    def __init__(self, script_text, out):
        self.dir = out
        script = out / "ranks.py"
        script.write_text(script_text)
        self._log = open(out / "ranks.log", "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "4", str(script), str(out)], cwd=str(out),
            env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"),
            stdout=self._log, stderr=subprocess.STDOUT)

    def result(self):
        rc = self.proc.wait(timeout=900)
        self._log.close()
        assert rc == 0, (self.dir / "ranks.log").read_text()[-4000:]
        with open(self.dir / "ranks.json") as f:
            return json.load(f)

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self._log.close()


@pytest.fixture(scope="module", autouse=True)
def _launch(tmp_path_factory):
    """The 4-rank launch, started before this module's first test so that
    it runs while the tests of world size 1 do."""
    launch = _Launch(_RANKS.format(src=SRC, tests=os.path.dirname(
        os.path.abspath(__file__))), tmp_path_factory.mktemp("lora_ranks"))
    yield launch
    launch.close()


# ---------------------------------------------------------------------------
# world size 1
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mesh():
    m = MESH.make_local_mesh(1, 1, device_type="cpu")
    yield m
    MESH.shutdown()


def test_lora_merge_bitwise_under_sharded_plan_matches_jax(mesh):
    """JAX's test in the port: a LoRA model (rank 4) through the gym under
    ``fsdp``, 2 steps; the merge contract holds bitwise for the plan's
    params, and the losses are JAX's same run's within ``CURVE_TOL``."""
    jlm = JLO.LoRAModel(jax_build_model(jax_get_reduced(QWEN)),
                        JLO.LoRAConfig(rank=4))
    lm = LO.LoRAModel(build_model(get_reduced(QWEN)), LO.LoRAConfig(rank=4))
    vocab = lm.cfg.vocab
    jout = JaxGym(model=jlm, optimizer=JLO.FrozenBaseOptimizer(
        JaxAdamW(lr=1e-3)), loader=JaxShardedLoader(JaxPackedSFTDataset(
            jax_sft_examples(64, vocab), seq_len=16), 4),
        mesh=JMESH.SingleDeviceMesh().build(), plan=jax_make_plan("fsdp"),
        log_every=1, prefetch=0).run(steps=2)
    opt = LO.FrozenBaseOptimizer(AdamW(lr=1e-3))
    gym = Gym(model=lm, optimizer=opt, loader=ShardedLoader(
        PackedSFTDataset(synthetic_sft_examples(64, vocab), seq_len=16), 4),
        mesh=mesh, plan=PL.make_plan("fsdp"), log_every=1, prefetch=0,
        device="cpu")
    gym.setup()
    params = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jlm.init(jax.random.PRNGKey(0))))
    state = PL.distribute({"params": params, "opt": opt.init(params),
                           "step": torch.zeros((), dtype=torch.int32)},
                          gym._state_sh)
    out = gym.run(2, state=state)
    got, want = _losses(out), _losses(jout)
    assert len(got) == 2 and got[-1] > 0
    for g, w in zip(got, want):
        assert abs(g - float(w)) <= CURVE_TOL * abs(float(w))
    params = out["state"]["params"]
    assert all(list(t.placements) == sh.placements for (_, t), (_, sh) in
               zip(flatten_with_paths(params),
                   flatten_with_paths(gym._state_sh["params"])))
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, vocab, (2, 12)).astype(np.int32))
    with torch.no_grad():
        merged = tree_map(lambda t: t.full_tensor(), lm.merge(params))
        plain = tree_map(lambda t: t.full_tensor(), params)
        want, _ = lm.base.apply(merged, {"tokens": toks})
        got, _ = lm.apply(plain, {"tokens": toks})
    assert torch.equal(got, want)


def test_sft_kind_under_fsdp_tp_at_world_size_one(tmp_path):
    """``sft`` under ``fsdp_tp`` on a ``local`` mesh of one device ``==``
    the run with no mesh: the losses, the adapter checkpoint's leaves and
    the merged export's arrays."""
    a = api.execute_doc(_doc("sft", str(tmp_path / "a")), device="cpu",
                        log=_quiet, write_result=True)
    b = api.execute_doc(_doc("sft", str(tmp_path / "b"), (1, 1), "fsdp_tp"),
                        device="cpu", log=_quiet, write_result=True)
    assert b["plan"].startswith("fsdp_tp(") and "plan" not in a
    assert _losses(a) == _losses(b) and len(_losses(a)) == STEPS
    pa, pb = (_ckpt_params(os.path.join(r["adapter_ckpt"], ".."))
              for r in (a, b))
    assert pa.keys() == pb.keys() and all(k.startswith("lora/") for k in pa)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    ea, eb = (np.load(r["merged_export"]) for r in (a, b))
    assert sorted(ea.files) == sorted(eb.files)
    assert all(np.array_equal(ea[k], eb[k]) for k in ea.files)


def test_sft_warmstart_from_a_base_donor_under_fsdp_tp(tmp_path):
    """``sft`` warmstarted from a checkpoint of the base alone (no
    adapters: they keep their fresh init, the exemption is logged) under
    ``fsdp_tp`` on one device ``==`` the run with no mesh, the restored
    leaves laid out by the plan."""
    from repro_torch.ckpt.format import write_checkpoint

    base = build_model(get_reduced(QWEN)).init(
        torch.Generator().manual_seed(7))
    donor = write_checkpoint(str(tmp_path / "donor"), 5, {
        f"params/{k}": v for k, v in flatten_with_paths(base)})
    runs = []
    for name, mesh, plan in (("a", None, None), ("b", (1, 1), "fsdp_tp")):
        doc = _doc("sft", str(tmp_path / name), mesh, plan)
        doc["run"]["sft"]["warmstart"] = {"source": donor,
                                          "optimizer": "fresh"}
        logs = []
        runs.append((api.execute_doc(doc, device="cpu", log=logs.append),
                     logs))
    (a, la), (b, lb) = runs
    assert _losses(a) == _losses(b) and len(_losses(a)) == STEPS
    for logs in (la, lb):
        assert any("donor has no adapters" in m for m in logs)
    assert not any(m.startswith("lora: shard warning") for m in lb)


def test_dpo_kind_under_fsdp_with_onpolicy_pairs_at_world_size_one(tmp_path):
    """``dpo`` under ``fsdp`` with on-policy pairs ``==`` the run with no
    mesh: the pairs come from an engine with no mesh over the gathered
    merged params, so they are the same, and so is every step's loss and
    margin; the first loss is ``log 2``."""
    a = api.execute_doc(_doc("dpo", str(tmp_path / "a"), onpolicy=True),
                        device="cpu", log=_quiet, write_result=True)
    b = api.execute_doc(_doc("dpo", str(tmp_path / "b"), (1, 1), "fsdp",
                             onpolicy=True),
                        device="cpu", log=_quiet, write_result=True)
    assert [(r["loss"], r["margin"]) for r in a["history"]] == \
        [(r["loss"], r["margin"]) for r in b["history"]]
    assert abs(b["history"][0]["loss"] - math.log(2)) <= 1e-6


def test_engine_over_a_lora_model_at_world_size_one(mesh):
    """``ServeEngine(lora_model, params, mesh, plan)`` under ``fsdp_tp``:
    the base and the adapters laid out by the LoRA model's ``param_axes``,
    the cache as the base's; its streams ``==`` the engine over the base
    model with ``merge(params)``, with no mesh."""
    lm = _lora_model()
    params = _trained(lm)
    eng = ServeEngine(lm, params, mesh=mesh, plan=PL.make_plan("fsdp_tp"),
                      **ENGINE)
    assert all(type(t).__name__ == "DTensor"
               for t in tree_leaves(eng.params[LO.ADAPTER_KEY]))
    got = [r["gen_ids"] for r in eng.run(_trace(), realtime=False,
                                         warmup=False)["requests"]]
    with torch.no_grad():
        want = _streams(lm.base, lm.merge(params))
    assert got == want


def _trained(lm, seed=1):
    """``lm``'s seed-0 init with seeded noise on every adapter factor (the
    ``b`` factors non-zero, so the adapters move the logits)."""
    params = lm.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(seed)
    params[LO.ADAPTER_KEY] = tree_map(
        lambda t: t + 0.05 * torch.randn(t.shape, generator=gen),
        params[LO.ADAPTER_KEY])
    return params


# ---------------------------------------------------------------------------
# 4 gloo ranks
# ---------------------------------------------------------------------------
_RANKS = textwrap.dedent('''
    import json, os, sys
    sys.path.insert(0, {src!r})
    sys.path.insert(0, {tests!r})
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    import test_torch_lora_mesh as T
    from repro_torch.ckpt import elastic as EL
    from repro_torch.ckpt.format import flatten_with_paths
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim.adamw import AdamW
    from repro_torch.posttrain import lora as LO
    from repro_torch.run import api
    from repro_torch.sharding import plans as PL
    from repro_torch.tree import tree_leaves

    out_dir = sys.argv[1]
    out = {{}}
    undo = T._f32_activations()
    for plan in T.SFT_PLANS:
        res = api.execute_doc(T._doc("sft", os.path.join(out_dir, plan),
                                     (2, 2), plan), device="cpu",
                              write_result=True)
        out[plan] = T._losses(res) if dist.get_rank() == 0 else None
    res = api.execute_doc(T._doc("dpo", os.path.join(out_dir, "dpo"),
                                 (2, 2), "fsdp_tp"), device="cpu",
                          write_result=True)
    out["dpo"] = T._losses(res) if dist.get_rank() == 0 else None
    undo()
    mesh = make_local_mesh(2, 2, device_type="cpu")
    ddp = PL.make_plan("ddp")
    lm = T._lora_model()
    params = lm.init(torch.Generator().manual_seed(0))
    sh, _ = PL.param_shardings(ddp, mesh, params, lm.param_axes())
    src = os.path.join(out_dir, "fsdp_tp")
    saved = T._ckpt_params(os.path.join(src, "adapter"))
    got = LO.load_adapter(PL.distribute(params, sh),
                          os.path.join(src, "adapter"), shardings=sh)
    ok = all(isinstance(t, DTensor) and list(t.placements) == s.placements
             and torch.equal(t.full_tensor(), saved["lora/" + k])
             for (k, t), s in zip(
                 flatten_with_paths(got[LO.ADAPTER_KEY]),
                 tree_leaves(sh[LO.ADAPTER_KEY])))
    opt = LO.FrozenBaseOptimizer(AdamW())
    state = EL.restore_train_state(
        {{"params": params, "opt": opt.init(params),
          "step": torch.zeros((), dtype=torch.int32)}},
        os.path.join(src, "ckpt"), plan=ddp, mesh=mesh, model=lm,
        optimizer=opt)
    full = T._ckpt_params(os.path.join(src, "ckpt"))
    ok_state = all(torch.equal(t.full_tensor(), full[k]) for k, t in
                   flatten_with_paths(state["params"]))
    eng_params = LO.load_adapter(params, os.path.join(src, "adapter"))
    streams = T._streams(lm, eng_params, mesh=mesh,
                         plan=PL.make_plan("fsdp_tp"))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (ok, ok_state, streams))
    out["load_adapter_ddp"] = all(e[0] for e in every)
    out["restore_ddp"] = all(e[1] for e in every)
    out["streams"] = streams
    out["same_streams_on_every_rank"] = all(e[2] == streams for e in every)
    if dist.get_rank() == 0:
        with open(os.path.join(out_dir, "ranks.json"), "w") as f:
            json.dump(out, f)
''')


@pytest.fixture(scope="module")
def ranks(_launch, tmp_path_factory):
    """The 4-rank launch's results; the runs with no mesh, in this process
    with the same f32 activations, while it finishes."""
    out = tmp_path_factory.mktemp("lora_one")
    undo = _f32_activations()
    try:
        one = {kind: api.execute_doc(_doc(kind, str(out / kind)),
                                     device="cpu", log=_quiet,
                                     write_result=True)
               for kind in ("sft", "dpo")}
    finally:
        undo()
    return {"ranks": _launch.result(), "dir": _launch.dir,
            "one": {k: _losses(v) for k, v in one.items()}}


@pytest.mark.parametrize("plan", SFT_PLANS)
def test_sft_kind_under_a_plan_on_four_ranks(ranks, plan):
    """Each loss of ``sft`` under ``plan`` on ``(2, 2)`` within
    ``LOSS_TOL`` of the run with no mesh; the final checkpoint's base
    leaves ``==`` their init, and its adapters moved."""
    got, want = ranks["ranks"][plan], ranks["one"]["sft"]
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        assert abs(g - w) <= LOSS_TOL * abs(w), (got, want)
    saved = _ckpt_params(str(ranks["dir"] / plan / "ckpt"))
    init = dict(flatten_with_paths(
        _lora_model().init(torch.Generator().manual_seed(0))))
    assert saved.keys() == init.keys()
    for k, v in init.items():
        assert torch.equal(saved[k], v) == (not LO.is_adapter_path(k)), k


def test_dpo_kind_under_fsdp_tp_on_four_ranks(ranks):
    """Each loss of ``dpo`` under ``fsdp_tp`` on ``(2, 2)`` within
    ``DPO_LOSS_TOL`` of the run with no mesh; the first is ``log 2``."""
    got, want = ranks["ranks"]["dpo"], ranks["one"]["dpo"]
    assert len(got) == len(want) == STEPS
    assert abs(got[0] - math.log(2)) <= 1e-6
    for g, w in zip(got, want):
        assert abs(g - w) <= DPO_LOSS_TOL * abs(w), (got, want)


def test_adapter_checkpoint_across_layouts(ranks):
    """The adapter checkpoint written under ``fsdp_tp`` (rank 0 alone,
    each leaf gathered) holds the gym checkpoint's adapters and reads back
    with no mesh through ``load_adapter``; on every rank under ``ddp``
    ``load_adapter(shardings=)`` restores it and ``restore_train_state``
    the gym checkpoint, ``==``."""
    src = ranks["dir"] / "fsdp_tp"
    adapter = _ckpt_params(str(src / "adapter"))
    full = _ckpt_params(str(src / "ckpt"))
    assert adapter.keys() == {k for k in full if LO.is_adapter_path(k)}
    assert all(torch.equal(v, full[k]) for k, v in adapter.items())
    lm = _lora_model()
    got = LO.load_adapter(lm.init(torch.Generator().manual_seed(0)),
                          str(src / "adapter"))
    assert all(torch.equal(t, adapter["lora/" + k]) for k, t in
               flatten_with_paths(got[LO.ADAPTER_KEY]))
    assert ranks["ranks"]["load_adapter_ddp"]
    assert ranks["ranks"]["restore_ddp"]
    assert os.path.exists(src / "merged" / "export.npz")


def test_engine_over_a_lora_model_on_four_ranks(ranks):
    """The engine over the LoRA model (the ``fsdp_tp`` run's adapters)
    under ``fsdp_tp`` on ``(2, 2)``: every rank draws the same greedy
    streams, each that of the engine over ``merge(params)`` with no mesh
    or parted where the latter's top-2 margin is within ``LOGIT_TOL``."""
    row = ranks["ranks"]
    assert row["same_streams_on_every_rank"]
    lm = _lora_model()
    params = LO.load_adapter(lm.init(torch.Generator().manual_seed(0)),
                             str(ranks["dir"] / "fsdp_tp" / "adapter"))
    with torch.no_grad():
        merged = lm.merge(params)
    want = _streams(lm.base, merged)
    same = 0
    for r, a, b in zip(_trace(), row["streams"], want):
        assert len(a) == len(b)
        if a == b:
            same += 1
            continue
        i = next(j for j in range(len(a)) if a[j] != b[j])
        toks = torch.as_tensor([list(r.prompt) + b[:i]])
        with torch.no_grad():
            logits = lm.base.apply(merged, {"tokens": toks})[0][0, -1]
        assert float(logits[b[i]] - logits[a[i]]) <= LOGIT_TOL, (a, b)
    assert same >= len(want) // 2
