"""The Zamba2 hybrid under JAX's sharding plans (ROADMAP A8b's last part)
on the CPU: reduced Zamba2 (2 Mamba2 layers, each followed by a use of
the one weight-shared attention block), its self-attention through the
flash kernel's plain version (``use_flash_kernel``), f32 activations in
training.

- 4 gloo ranks, one ``torchrun`` launch (``_RANKS``):
  - 3 AdamW steps under ``ddp``, ``fsdp``, ``fsdp_tp`` and ``hsdp`` on a
    ``(2, 2)`` and a ``(1, 4)`` ``data x model`` mesh: losses within
    ``LOSS_TOL`` of the port's one-device steps, every param leaf laid
    out with the plan's placements after the steps;
  - one step's per-leaf gradients under ``fsdp_tp`` and ``fsdp`` against
    the one-device ones (``GRAD_TOL``), the shared block's among them:
    its gradient is the sum over its uses, where a double count or a
    missing reduce would show;
  - the dense engine under ``fsdp_tp`` on both meshes: every rank draws
    the same streams, the pool's leaves (the shared block's K/V ``[n_attn,
    B, S, K, dh]`` among them) have ``plans.cache_specs``' placements, and
    the streams equal the one-device run's or part where JAX's own top-2
    margin is within ``LOGIT_TOL`` (ROADMAP C2);
  - a checkpoint saved under ``fsdp_tp`` on ``(2, 2)`` restores under
    ``ddp`` on ``(4, 1)`` and with no mesh ``==``; its manifest carries
    the shared block's specs.
- A JAX subprocess on 8 forced host devices: JAX's 2 steps under each plan
  on the same meshes from the same numpy params (``JAX_LOSS_TOL``, JAX's
  own bound), and JAX's dryrun of reduced train and decode cases on ``(2,
  4)`` against the port's on a fake world of 8 (``EQUAL_KEYS``, the
  argument bytes among them).
- In this process, world size 1 first (a one-rank gloo group, as the card
  runs a plan): a train step and the engine under ``fsdp_tp`` ``==`` no
  mesh.  Then fake worlds: the shared block gathered once a step and its
  gradient reduce-scattered once; full-width ``train_4k`` and
  ``long_500k`` on 256 fake ranks (``model_flops_global`` JAX's
  ``model_flops``, the warnings JAX's), no process group left; the
  full-width warnings under ``fsdp_tp`` at ``(1, 4)`` and ``(2, 2)``
  JAX's; a pipe axis keeps raising JAX's ``ValueError``; ROADMAP C10:
  at 6 layers a chunk decay passes ``F32_EXP_MAX`` (C1), and JAX's
  gradient is not finite where the port's is.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.bridge import params_to_numpy
from repro_torch.configs import get_config, get_reduced
from repro_torch.device import MetaGenerator
from repro_torch.launch import mesh as MESH
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.workload import static_trace
from repro_torch.sharding import plans as PL
from repro_torch.train import steps as ST

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
ARCH = "zamba2_2p7b"
#: relative, f32 activations: a plan changes only the order of f32 sums
#: (A8a's bound, ``tests/test_torch_mesh_train.py``)
LOSS_TOL = 1e-5
#: relative, against JAX's sharded steps (JAX's own bound between its
#: plans, ``tests/test_sharding.py``): the two packages' kernels sum in
#: other orders
JAX_LOSS_TOL = 2e-2
#: per leaf, relative to the leaf's largest one-device gradient
GRAD_TOL = 1e-5
#: a near-tie in JAX's logits (``tests/test_torch_engine.py``)
LOGIT_TOL = 3e-2
PLANS = ("ddp", "fsdp", "fsdp_tp", "hsdp")
MESHES = ((2, 2), (1, 4))
GRAD_PLANS = ("fsdp", "fsdp_tp")
SHIM = dict(batch=4, prompt_len=32, gen=8, seed=0)
#: the dryrun cases: train- and decode-shaped inputs, reduced
DRY_SHAPES = {"train": {"seq_len": 64, "global_batch": 8, "kind": "train"},
              "decode": {"seq_len": 64, "global_batch": 8, "kind": "decode"}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Reduced models: one thread for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(n_layers=4):
    return get_reduced(ARCH).with_(n_layers=n_layers, use_flash_kernel=True)


def _model(f32=True):
    """Reduced Zamba2, with f32 activations (its embedding's output) for
    the training checks."""
    model = build_model(_cfg())
    if f32:
        embed = model.embed_tokens
        model.embed_tokens = lambda p, t, dtype=None: embed(
            p, t, dtype=torch.float32)
    return model


def _batch():
    toks = np.random.default_rng(1).integers(3, 512, (8, 32))
    return {"tokens": toks.astype(np.int32),
            "labels": np.roll(toks, -1, 1).astype(np.int32)}


def _laid(model, opt, plan, mesh):
    """(state, step, the batch) from the seed-0 init: with no mesh, or
    laid out under ``plan`` on ``mesh``."""
    state = ST.init_train_state(model, opt, torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v) for k, v in _batch().items()}
    ctx = None
    if plan is not None:
        pl = PL.make_plan(plan)
        sh, _ = PL.train_state_shardings(pl, mesh, model, opt)
        state = PL.distribute(state, sh)
        ctx = PL.mesh_context(pl, mesh)
        batch = PL.distribute(batch, PL.batch_shardings(pl, mesh, batch))
    return state, ST.make_train_step(model, opt, ctx), batch, ctx


def _train(plan=None, mesh=None, steps=3):
    """The losses of ``steps`` AdamW steps, and whether every param leaf
    ends laid out with the plan's placements."""
    model, opt = _model(), AdamW(lr=1e-3)
    state, step, batch, _ = _laid(model, opt, plan, mesh)
    losses = []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    layout = True
    if plan is not None:
        from repro_torch.tree import tree_leaves

        specs, _ = PL.param_specs(PL.make_plan(plan), mesh, state["params"],
                                  model.param_axes())
        layout = all(list(t.placements) == PL.spec_placements(mesh, s)
                     for t, s in zip(tree_leaves(state["params"]),
                                     tree_leaves(specs)))
    return losses, layout


def _grads(plan=None, mesh=None):
    """One step's gradients, whole, by leaf path."""
    model, opt = _model(), AdamW(lr=1e-3)
    state, _, batch, ctx = _laid(model, opt, plan, mesh)
    _, g = ST.value_and_grad(
        lambda p, b: ST.compute_loss(model, p, b, ctx), state["params"],
        batch)
    return {k: v.full_tensor() if hasattr(v, "full_tensor") else v
            for k, v in PL._flatten(g)}


def _prompts():
    return np.random.default_rng(SHIM["seed"] + 1).integers(
        3, _cfg().vocab, size=(SHIM["batch"], SHIM["prompt_len"]),
        dtype=np.int32)


def _engine(model, params, **kw):
    """The serving shim's engine (``serve_benchmark``'s: the dense pool,
    greedy, a static batch), with no warm-up pass."""
    return ServeEngine(model, params, n_slots=SHIM["batch"],
                       max_len=SHIM["prompt_len"] + SHIM["gen"], greedy=True,
                       block_len=0, **kw)


def _streams(model, params, **kw):
    eng = _engine(model, params, **kw)
    res = eng.run(static_trace(_prompts(), SHIM["gen"], seed=SHIM["seed"]),
                  realtime=False, warmup=False)
    return [r["gen_ids"] for r in res["requests"]]


def _dry_doc(shape, out, mesh=None):
    from test_torch_dryrun import _doc

    return _doc(ARCH, DRY_SHAPES[shape], out, mesh=mesh or {"dp": 2,
                                                            "tp": 4},
                plan="fsdp_tp")


_RANKS = textwrap.dedent('''
    import json, os, sys
    sys.path.insert(0, {src!r})
    sys.path.insert(0, {tests!r})
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    import test_torch_hybrid_mesh as T
    from repro_torch.ckpt import AsyncCheckpointer
    from repro_torch.ckpt import elastic as EL
    from repro_torch.ckpt.format import read_manifest
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim.adamw import AdamW
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.sharding import plans as PL
    from repro_torch.tree import tree_leaves

    out = {{"train": {{}}, "grads": {{}}, "serve": {{}}}}
    meshes = {{s: make_local_mesh(*s, device_type="cpu")
               for s in T.MESHES + ((4, 1),)}}
    for dp, tp in T.MESHES:
        for plan in T.PLANS:
            losses, layout = T._train(plan, meshes[(dp, tp)])
            out["train"][f"{{plan}}-{{dp}}x{{tp}}"] = {{"losses": losses,
                                                      "layout": layout}}
    ref = T._grads()
    for plan in T.GRAD_PLANS:
        got = T._grads(plan, meshes[(2, 2)])
        out["grads"][plan] = {{
            k: float((got[k] - ref[k]).abs().max()
                     / ref[k].abs().max().clamp_min(1e-30)) for k in ref}}

    pools = []
    make = ServeEngine._init_pool

    def keep(self):
        cache, slots = make(self)
        pools.append((self, cache))
        return cache, slots

    ServeEngine._init_pool = keep
    model = T._model(f32=False)
    params = model.init(torch.Generator().manual_seed(0))
    plan = PL.make_plan("fsdp_tp")
    for dp, tp in T.MESHES:
        mesh = meshes[(dp, tp)]
        pools.clear()
        streams = T._streams(model, params, mesh=mesh, plan=plan)
        eng, cache = pools[-1]
        specs = PL.cache_specs(plan, mesh, model.init_cache(
            eng.n_slots, eng.max_len, device="meta"))
        layout = all(isinstance(t, DTensor) and list(t.placements)
                     == PL.spec_placements(mesh, s)
                     for t, s in zip(tree_leaves(cache), tree_leaves(specs)))
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, (streams, layout))
        out["serve"][f"{{dp}}x{{tp}}"] = {{
            "streams": streams,
            "same_on_every_rank": all(e[0] == streams for e in every),
            "layout_on_every_rank": all(e[1] for e in every),
            "specs": {{k: PL.spec_to_json(s)
                       for k, s in PL._flatten(specs)}}}}

    # a checkpoint saved under fsdp_tp restores under ddp and with no mesh
    model, opt = T._model(), AdamW(lr=1e-3)
    st, step, batch, _ = T._laid(model, opt, "fsdp_tp", meshes[(2, 2)])
    for _ in range(2):
        st, _ = step(st, batch)
    ck = AsyncCheckpointer(os.path.join(sys.argv[1], "ck"))
    ck.save(st, 2)
    ck.wait()
    ck.close()
    saved = [t.full_tensor() for t in tree_leaves(st)]
    like = {{"params": model.init(torch.Generator().manual_seed(1)),
             "opt": None, "step": torch.zeros((), dtype=torch.int32)}}
    like["opt"] = opt.init(like["params"])
    path = ck.latest()[1]
    ddp = EL.restore_train_state(like, path, plan=PL.make_plan("ddp"),
                                 mesh=meshes[(4, 1)], model=model,
                                 optimizer=opt)
    plain = EL.restore(like, path, device="cpu")
    want, _ = PL.param_specs(PL.make_plan("fsdp_tp"), meshes[(2, 2)],
                             st["params"], model.param_axes())
    out["ckpt"] = {{
        "ddp": all(isinstance(t, DTensor)
                   and all(p.is_replicate() for p in t.placements)
                   and torch.equal(t.full_tensor(), s)
                   for t, s in zip(tree_leaves(ddp), saved)),
        "plain": all(type(t) is torch.Tensor and torch.equal(t, s)
                     for t, s in zip(tree_leaves(plain), saved)),
        "path": path,
        "want_specs": {{k: PL.spec_to_json(s)
                        for k, s in PL._flatten(want["shared_attn"])}}}}
    if dist.get_rank() == 0:
        with open(os.path.join(sys.argv[1], "ranks.json"), "w") as f:
            json.dump(out, f)
''')

_JAX = textwrap.dedent('''
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, sys.argv[1])
    sys.path.insert(0, sys.argv[2])
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_reduced
    from repro.launch.mesh import make_local_mesh
    from repro.models import build_model
    from repro.optim.adamw import AdamW
    from repro.run import api
    from repro.sharding import plans as PL
    from repro.train import steps as ST
    import test_torch_hybrid_mesh as T
    from test_torch_dryrun import EQUAL_KEYS

    flat = np.load(sys.argv[3])
    params = {}
    for key in flat.files:
        node = params
        *head, last = key.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = jnp.asarray(flat[key])
    model = build_model(get_reduced(T.ARCH))
    embed = model.embed_tokens
    model.embed_tokens = lambda p, t, dtype=None: embed(p, t, jnp.float32)
    batch = {k: jnp.asarray(v) for k, v in T._batch().items()}
    out = {"train": {}, "dryrun": {}}
    for dp, tp in T.MESHES:
        mesh = make_local_mesh(dp, tp)
        for name in T.PLANS:
            plan = PL.make_plan(name)
            opt = AdamW(lr=1e-3)
            state = {"params": params, "opt": opt.init(params),
                     "step": jnp.zeros((), jnp.int32)}
            sh, _ = PL.train_state_shardings(plan, mesh, model, opt)
            with mesh:
                state = jax.device_put(state, sh)
                step = jax.jit(ST.make_train_step(
                    model, opt, PL.mesh_context(plan, mesh)),
                    in_shardings=(sh, None), out_shardings=(sh, None))
                rows = []
                for _ in range(2):
                    state, m = step(state, batch)
                    rows.append(float(m["loss"]))
            out["train"][f"{name}-{dp}x{tp}"] = rows
    for shape in T.DRY_SHAPES:
        res = api.execute_doc(T._dry_doc(shape, sys.argv[4] + shape),
                              write_files=False)
        out["dryrun"][shape] = {k: res[k] for k in EQUAL_KEYS}
    with open(sys.argv[5], "w") as f:
        json.dump(out, f)
''')


@pytest.fixture(scope="module", autouse=True)
def _launch(tmp_path_factory):
    """The 4-rank launch and the JAX subprocess, started together before
    this module's first test (each writes its output to a file: a pipe
    left unread could fill and stall it)."""
    from repro_torch.ckpt.format import flatten_with_paths

    out = tmp_path_factory.mktemp("hybrid_mesh")
    here = os.path.dirname(os.path.abspath(__file__))
    init = params_to_numpy(_model().init(torch.Generator().manual_seed(0)))
    np.savez(out / "params.npz", **dict(flatten_with_paths(init)))
    script = out / "ranks.py"
    script.write_text(_RANKS.format(src=SRC, tests=here))
    logs = {k: open(out / f"{k}.log", "w") for k in ("ranks", "jax")}
    procs = {
        "ranks": subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "4", str(script), str(out)], cwd=str(out),
            env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"),
            stdout=logs["ranks"], stderr=subprocess.STDOUT),
        "jax": subprocess.Popen(
            [sys.executable, "-c", _JAX, SRC, here, str(out / "params.npz"),
             str(out / "jax_dry_"), str(out / "jax.json")],
            env=dict(os.environ, JAX_PLATFORMS="cpu"),
            stdout=logs["jax"], stderr=subprocess.STDOUT)}
    yield out, procs
    for k, p in procs.items():
        if p.poll() is None:
            p.kill()
            p.wait()
        logs[k].close()


# ---------------------------------------------------------------------------
# world size 1
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mesh1():
    m = MESH.make_local_mesh(1, 1, device_type="cpu")
    yield m
    MESH.shutdown()


def test_train_step_and_engine_at_world_size_one(mesh1):
    """Under ``fsdp_tp`` on a one-rank mesh a train step's losses and the
    engine's streams ``==`` the unsharded runs' (every kernel runs on the
    whole blocks)."""
    assert _train("fsdp_tp", mesh1, steps=2) == (_train(steps=2)[0], True)
    model = _model(f32=False)
    params = model.init(torch.Generator().manual_seed(0))
    assert _streams(model, params, mesh=mesh1,
                    plan=PL.make_plan("fsdp_tp")) == _streams(model, params)


# ---------------------------------------------------------------------------
# fake worlds (after the one-rank group: a fake world takes it down)
# ---------------------------------------------------------------------------
def test_shared_block_is_gathered_once_and_reduced_once():
    """One ``fsdp`` train step of Zamba2 at 6 layers on a fake world of 8:
    the shared block's ``wq`` and ``wo`` (the only leaves of their size)
    are all-gathered once each, though the block runs 3 times and the
    remat recompute runs each use again, and their gradients, summed over
    the uses, are reduce-scattered once each."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch.dryrun import build_step
    from repro_torch.launch.hlo_analysis import analyze

    cfg = _cfg(n_layers=6)
    n = 4 * cfg.d_model * cfg.n_heads * cfg.head_dim_
    with MESH.fake_world(8):
        mesh = MESH.make_local_mesh(8, 1, device_type=MESH.FAKE_DEVICE_TYPE)
        setup = build_step(build_model(cfg), InputShape("t", 32, 8, "train"),
                           mesh, PL.make_plan("fsdp"))
        _, ana = analyze(setup.fn, *setup.args)
    count = {k: c for k, b, c in ana["messages"] if b == n}
    assert count == {"all-gather": 2, "reduce-scatter": 2}, ana["messages"]
    assert not dist.is_initialized()


def _jax_full_warnings(name, sizes):
    """JAX's ``leaf_spec`` warnings of the full-width tree (``eval_shape``
    on no device) under ``name`` on a stand-in mesh of ``sizes``."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    from repro.sharding import plans as JPL
    from test_torch_plans import _FakeMesh

    model = jax_build_model(jax_get_config(ARCH))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    paths = jax.tree_util.tree_flatten_with_path(shapes)[0]
    axes = jax.tree_util.tree_flatten(
        model.param_axes(), is_leaf=lambda t: isinstance(t, tuple))[0]
    warns = []
    for (p, leaf), ax in zip(paths, axes):
        JPL.leaf_spec(JPL.make_plan(name), _FakeMesh(sizes),
                      tuple(leaf.shape), ax, warns, jax.tree_util.keystr(p))
    return warns


@pytest.mark.parametrize("sizes", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
def test_full_width_warnings_equal_jax(sizes):
    """Full-width Zamba2's ``param_shardings`` warnings under ``fsdp_tp``
    (``meta`` shapes, no allocation) ``==`` JAX's."""
    model = build_model(get_config(ARCH))
    shapes = model.init(MetaGenerator().manual_seed(0))
    grid = {"data": sizes[0], "model": sizes[1]}
    _, warns = PL.param_specs(PL.make_plan("fsdp_tp"), grid, shapes,
                              model.param_axes())
    assert warns == _jax_full_warnings("fsdp_tp", grid)


@pytest.mark.parametrize("shape", ["train_4k", "long_500k"])
def test_full_width_dryrun_on_256_fake_ranks(tmp_path, shape):
    """Full-width Zamba2 under its default plan, ``fsdp_tp``, on the
    production mesh's fake world of 256 ranks: ``model_flops_global`` ``==``
    JAX's ``model_flops(cfg, shape)``, the warnings JAX's, collectives
    counted, and no process group left.  ``long_500k`` decodes one row
    against a 524,288-row cache of 9 uses, the sequence over ``data``
    (the batch of one does not divide it)."""
    from repro.configs import get_config as jax_get_config
    from repro.configs.shapes import SHAPES as JSHAPES
    from repro.telemetry.accounting import model_flops as jax_model_flops
    from repro_torch.run import api

    doc = {"run": {"kind": "dryrun", "name": "z", "output_dir": str(tmp_path)},
           "arch": {"component_key": "arch_config", "variant_key": ARCH},
           "shape": {"component_key": "shape", "variant_key": shape}}
    res = api.execute_doc(doc, device="cpu", log=lambda _m: None)
    assert res["plan"] == "fsdp_tp(dp=data; fsdp=data; tp=model)"
    assert res["chips"] == 256
    assert res["model_flops_global"] == jax_model_flops(
        jax_get_config(ARCH), JSHAPES[shape])[0]
    assert res["sharding_warnings"] == _jax_full_warnings(
        "fsdp_tp", {"data": 16, "model": 16})
    assert res["hlo_flops_per_dev"] > 0
    assert res["collective_counts"]["all-gather"] > 0
    assert not dist.is_initialized()


def test_pipe_axis_keeps_refusing_the_hybrid():
    """A plan with a pipe axis raises JAX's ``ValueError``: the
    weight-shared block does not compose with the GPipe schedule."""
    from repro_torch.models.base import MeshContext

    model = _model()
    ctx = MeshContext(pp=2)           # the stage-local schedule, no mesh
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v) for k, v in _batch().items()}
    with pytest.raises(ValueError, match="weight-shared hybrid stack"):
        model.apply(params, batch, ctx)


# ---------------------------------------------------------------------------
# 4 gloo ranks and JAX
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(_launch):
    """The port's one-device curve, in this process, then both launches'
    results."""
    out, procs = _launch
    one = _train()[0]
    for k, p in procs.items():
        assert p.wait(timeout=900) == 0, \
            (out / f"{k}.log").read_text()[-4000:]
    with open(out / "ranks.json") as f:
        got = json.load(f)
    with open(out / "jax.json") as f:
        jax_out = json.load(f)
    return {"ranks": got, "one": one, "jax": jax_out}


@pytest.mark.parametrize("mesh", MESHES, ids=["2x2", "1x4"])
@pytest.mark.parametrize("plan", PLANS)
def test_train_steps_under_a_plan(runs, plan, mesh):
    """3 steps on 4 ranks within ``LOSS_TOL`` of the one-device steps,
    every leaf laid out as the plan says; the first 2 within
    ``JAX_LOSS_TOL`` of JAX's steps under the same plan and mesh."""
    key = f"{plan}-{mesh[0]}x{mesh[1]}"
    row = runs["ranks"]["train"][key]
    assert row["layout"]
    assert row["losses"][2] < row["losses"][0]
    for got, want in zip(row["losses"], runs["one"]):
        assert abs(got - want) <= LOSS_TOL * want, (row, runs["one"])
    for got, want in zip(row["losses"], runs["jax"]["train"][key]):
        assert abs(got - want) <= JAX_LOSS_TOL * want, key


@pytest.mark.parametrize("plan", GRAD_PLANS)
def test_gradients_equal_the_one_device_ones(runs, plan):
    """Every leaf's gradient within ``GRAD_TOL`` of the one-device one,
    the shared block's 9 leaves (each used twice a step) among them."""
    errs = runs["ranks"]["grads"][plan]
    shared = [k for k in errs if k.startswith("['shared_attn']")]
    assert len(shared) == 9 and len(errs) > len(shared)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])


def _jax_logits(prompt, prefix):
    """JAX's logits after ``prompt + prefix``: its prefill of the prompt,
    then its decode steps over ``prefix`` (a Mamba2 prefill needs a
    multiple of the SSD chunk)."""
    import jax.numpy as jnp

    from repro.configs import get_reduced as jax_get_reduced
    from repro.models import build_model as jax_build_model

    jm = jax_build_model(jax_get_reduced(ARCH))
    params = _jax_params()
    logits, cache = jm.prefill(params, {"tokens": jnp.asarray([prompt])},
                               max_len=len(prompt) + len(prefix) + 1)
    for i, t in enumerate(prefix):
        logits, cache = jm.decode_step(
            params, cache, jnp.asarray([t], jnp.int32),
            jnp.asarray([len(prompt) + i], jnp.int32))
    return np.asarray(logits[0], np.float32)


def _jax_params():
    import jax

    model = _model()
    return jax.tree_util.tree_map(
        np.asarray, params_to_numpy(model.init(
            torch.Generator().manual_seed(0))))


@pytest.mark.parametrize("mesh", MESHES, ids=["2x2", "1x4"])
def test_engine_under_fsdp_tp(runs, mesh):
    """Every rank draws the same greedy streams; the pool's leaves have
    ``cache_specs``' placements on every rank (the shared block's K/V
    heads over ``model`` on ``(2, 2)``, its sequence on ``(1, 4)``, where
    the 2 KV heads do not divide it); each stream equals the one-device
    run's or parts where JAX's top-2 margin is within ``LOGIT_TOL``."""
    row = runs["ranks"]["serve"][f"{mesh[0]}x{mesh[1]}"]
    assert row["same_on_every_rank"] and row["layout_on_every_rank"]
    spec = row["specs"]["['shared_attn']['k']"]
    assert spec[3 if mesh == (2, 2) else 2] == "model", spec
    model = _model(f32=False)
    want = _streams(model, model.init(torch.Generator().manual_seed(0)))
    same = 0
    for prompt, a, b in zip(_prompts(), row["streams"], want):
        assert len(a) == len(b)
        if a == b:
            same += 1
            continue
        i = next(j for j in range(len(a)) if a[j] != b[j])
        logits = _jax_logits(list(prompt), b[:i])
        assert float(logits.max() - logits[a[i]]) <= LOGIT_TOL, (a, b)
    assert same >= len(want) // 2


def test_checkpoint_across_layouts(runs):
    """Saved under ``fsdp_tp`` on ``(2, 2)``: restored under ``ddp`` on
    ``(4, 1)`` (replicated DTensors) and with no mesh, every leaf ``==``
    the saved one; the manifest records the shared block's leaves with
    their ``fsdp_tp`` specs."""
    from repro_torch.ckpt.format import read_manifest

    row = runs["ranks"]["ckpt"]
    assert row["ddp"] and row["plain"]
    man = read_manifest(row["path"])
    got = {k[len("params/shared_attn/"):]: v["spec"]
           for k, v in man["leaves"].items()
           if k.startswith("params/shared_attn/")}
    want = {k.replace("']['", "/").strip("[']"): v
            for k, v in row["want_specs"].items()}
    assert got == want and len(got) == 9


@pytest.mark.parametrize("shape", list(DRY_SHAPES))
def test_reduced_dryrun_matches_jax(tmp_path, runs, shape):
    """The port's dryrun on a fake world of 8 against JAX's on 8 forced
    devices, ``fsdp_tp`` on ``(2, 4)``: ``EQUAL_KEYS`` ``==``, the argument
    bytes among them."""
    from repro_torch.run import api
    from test_torch_dryrun import EQUAL_KEYS

    res = api.execute_doc(_dry_doc(shape, str(tmp_path)), device="cpu",
                          log=lambda _m: None)
    want = runs["jax"]["dryrun"][shape]
    for key in EQUAL_KEYS:
        assert res[key] == want[key], (key, res[key], want[key])
    assert res["collective_counts"]["all-gather"] > 0
    assert not dist.is_initialized()


#: ``log`` of the largest f32: ``exp`` overflows above it (ROADMAP C1)
F32_EXP_MAX = float(np.log(np.finfo(np.float32).max))


def _chunk_decays(monkeypatch, n_layers):
    """The port's loss and gradient of reduced Zamba2 at ``n_layers`` from
    the seed-0 init, and the largest decay inside one scan chunk that each
    Mamba2 layer's forward meets: ``max(Sa_0 - Sa_{Q-1})`` over the
    chunks, what JAX's ``ssd_chunked`` exponentiates above the diagonal
    before it masks."""
    from repro_torch.models import ssm as SSM

    decays, scan = [], SSM.ssd_scan

    def probe(x, dt, A, Bm, Cm, D, chunk):
        a = -(dt.detach().double() * A.detach().double())     # [B, S, H]
        a = a.reshape(a.shape[0], -1, chunk, a.shape[-1])[:, :, 1:]
        decays.append(float(a.sum(2).max()))
        return scan(x, dt, A, Bm, Cm, D, chunk=chunk)

    monkeypatch.setattr(SSM, "ssd_scan", probe)
    cfg = get_reduced(ARCH).with_(n_layers=n_layers)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v) for k, v in _batch().items()}
    _, grads = ST.value_and_grad(
        lambda p, b: ST.compute_loss(model, p, b), params, batch)
    return params, grads, decays


def test_jax_gradient_at_six_layers_is_not_finite_where_the_ports_is(
        monkeypatch):
    """ROADMAP C10, which is C1 (why the comparisons with JAX run reduced
    Zamba2 at its 4 layers): at 6 layers, from the port's seed-0 init as
    numpy and ``_batch``'s tokens, the third Mamba2 layer meets a chunk
    decay above ``F32_EXP_MAX``, so JAX's ``exp`` before the mask
    overflows and its gradient through the hybrid backbone holds NaN
    below the final norm; the port masks before the ``exp`` and its
    gradient is finite.  At 4 layers every decay stays below the bound
    and JAX's gradient is finite (the file's other comparisons)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced as jax_get_reduced
    from repro.models import build_model as jax_build_model
    from repro.train import steps as JST

    _, _, short = _chunk_decays(monkeypatch, 4)
    assert max(short) < F32_EXP_MAX, short
    params, grads, decays = _chunk_decays(monkeypatch, 6)
    assert max(decays) > F32_EXP_MAX, decays
    assert all(bool(torch.isfinite(g).all()) for _, g in PL._flatten(grads))
    jm = jax_build_model(jax_get_reduced(ARCH).with_(n_layers=6))
    jp = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(params))
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}
    jg = jax.grad(lambda p: JST.compute_loss(jm, p, jb)[0])(jp)
    bad = {jax.tree_util.keystr(k) for k, v in
           jax.tree_util.tree_flatten_with_path(jg)[0]
           if not bool(jnp.isfinite(v).all())}
    assert "['shared_attn']['attn']['wq']" in bad
    assert "['final_norm']['scale']" not in bad
