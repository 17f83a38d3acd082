"""Whisper's encoder-decoder and LLaVA's patch prefix under JAX's sharding
plans (ROADMAP A8b's last part) on the CPU.  Whisper is reduced with 6
heads of 6 KV heads (Whisper-tiny's count: they do not divide a ``model``
axis of 4, so ``leaf_spec`` replicates its attention weights and
``cache_specs`` puts the caches' sequence over ``model``) and an odd vocab
of 515 (Whisper-tiny's 51,865 is odd: the tied embedding and the logits
stay whole over ``model``); LLaVA is reduced (16 patches, 4 heads of 2 KV
heads).  Training runs f32 activations.

- 4 gloo ranks, one ``torchrun`` launch (``_RANKS``):
  - 3 AdamW steps under ``ddp``, ``fsdp``, ``fsdp_tp`` and ``hsdp`` on a
    ``(2, 2)`` and a ``(1, 4)`` ``data x model`` mesh, Whisper also on
    ``(4, 1)``: losses within ``LOSS_TOL`` of the port's one-device steps,
    every leaf laid out with the plan's placements; the batch's ``frames``
    and ``patch_embeds`` laid out with its tokens;
  - one step's per-leaf gradients under ``fsdp_tp`` on both meshes
    against the one-device ones (``GRAD_TOL``);
  - the serving shims under ``fsdp_tp`` on both meshes, on JAX's shim
    prompts: every rank draws the same streams, and the cache's leaves
    (the self and the cross K/V) have ``cache_specs``' placements.
- A JAX subprocess on 8 forced host devices: JAX's 2 steps under each plan
  and mesh from the same numpy params (``JAX_LOSS_TOL``); JAX's shims with
  and without ``mesh``/``plan`` (ROADMAP C9: JAX drops them); JAX's dryrun
  of reduced train and decode cases on ``(2, 4)``.
- In this process, world size 1 first: a train step and the shim under
  ``fsdp_tp`` ``==`` no mesh.  Then the streams against the one-device
  shim and JAX's (``LOGIT_TOL``), the dryruns against JAX's and at full
  width on 256 fake ranks, and the full-width warnings.
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
from repro_torch.launch.serve import _multimodal_benchmark, serve_benchmark
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.sharding import plans as PL
from repro_torch.train import steps as ST

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
ARCHS = ("whisper_tiny", "llava_next_34b")
#: relative, f32 activations: a plan changes only the order of f32 sums
#: (A8a's bound, ``tests/test_torch_mesh_train.py``)
LOSS_TOL = 1e-5
#: relative, against JAX's sharded steps (JAX's own bound between its
#: plans, ``tests/test_sharding.py``)
JAX_LOSS_TOL = 2e-2
#: per leaf, relative to the leaf's largest one-device gradient; Whisper's
#: key biases, whose gradient is 0 in exact arithmetic
#: (``tests/test_torch_encdec.py``), against the tree's largest
GRAD_TOL = 1e-5
#: a near-tie in JAX's logits (``tests/test_torch_engine.py``)
LOGIT_TOL = 3e-2
PLANS = ("ddp", "fsdp", "fsdp_tp", "hsdp")
MESHES = {"whisper_tiny": ((2, 2), (1, 4), (4, 1)),
          "llava_next_34b": ((2, 2), (1, 4))}
SERVE_MESHES = ((2, 2), (1, 4))
SHIM = dict(batch=4, prompt_len=32, gen=8, seed=0)
DRY_SHAPES = {"train": {"seq_len": 64, "global_batch": 8, "kind": "train"},
              "decode": {"seq_len": 64, "global_batch": 8, "kind": "decode"}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Reduced models: one thread for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, get=get_reduced):
    """The reduced config (``get``: either package's ``get_reduced``)."""
    cfg = get(arch)
    if arch == "whisper_tiny":
        cfg = cfg.with_(n_heads=6, n_kv_heads=6, vocab=515)
    return cfg


def _model(arch, f32=True):
    """The reduced arch, with f32 activations for the training checks."""
    model = build_model(_cfg(arch))
    if f32 and arch == "whisper_tiny":
        model.act_dtype = torch.float32
    elif f32:
        embed = model.embed_tokens
        model.embed_tokens = lambda p, t, dtype=None: embed(
            p, t, dtype=torch.float32)
    return model


def _batch(arch):
    cfg = _cfg(arch)
    rng = np.random.default_rng(1)
    toks = rng.integers(3, cfg.vocab, (8, 32))
    out = {"tokens": toks.astype(np.int32),
           "labels": np.roll(toks, -1, 1).astype(np.int32)}
    if arch == "whisper_tiny":
        out["frames"] = rng.standard_normal(
            (8, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    else:
        out["patch_embeds"] = rng.standard_normal(
            (8, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return out


def _init(arch):
    return _model(arch).init(torch.Generator().manual_seed(0))


def _laid(arch, plan, mesh):
    """(model, state, step, batch, ctx) from the seed-0 init, with no mesh
    or laid out under ``plan`` on ``mesh``."""
    model, opt = _model(arch), AdamW(lr=1e-3)
    state = ST.init_train_state(model, opt, torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v) for k, v in _batch(arch).items()}
    ctx = None
    if plan is not None:
        pl = PL.make_plan(plan)
        sh, _ = PL.train_state_shardings(pl, mesh, model, opt)
        state = PL.distribute(state, sh)
        ctx = PL.mesh_context(pl, mesh)
        batch = PL.distribute(batch, PL.batch_shardings(pl, mesh, batch))
    return model, state, ST.make_train_step(model, opt, ctx), batch, ctx


def _train(arch, plan=None, mesh=None, steps=3):
    """The losses of ``steps`` steps, and whether every param leaf ends
    laid out with the plan's placements and the batch's extras with its
    tokens."""
    from repro_torch.tree import tree_leaves

    model, state, step, batch, _ = _laid(arch, plan, mesh)
    losses = []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    layout = True
    if plan is not None:
        specs, _ = PL.param_specs(PL.make_plan(plan), mesh, state["params"],
                                  model.param_axes())
        extra = [k for k in batch if k not in ("tokens", "labels")]
        layout = all(list(t.placements) == PL.spec_placements(mesh, s)
                     for t, s in zip(tree_leaves(state["params"]),
                                     tree_leaves(specs))) and all(
            batch[k].placements == batch["tokens"].placements
            for k in extra)
    return losses, layout


def _grads(arch, plan=None, mesh=None):
    model, state, _, batch, ctx = _laid(arch, plan, mesh)
    _, g = ST.value_and_grad(
        lambda p, b: ST.compute_loss(model, p, b, ctx), state["params"],
        batch)
    return {k: v.full_tensor() if hasattr(v, "full_tensor") else v
            for k, v in PL._flatten(g)}


def _shim(arch, prompts, **kw):
    """The shim's streams on ``prompts`` (``serve_benchmark``'s static
    path), with no mesh or under ``mesh``/``plan``."""
    model = _model(arch, f32=False)
    res = _multimodal_benchmark(model, model.init(
        torch.Generator().manual_seed(0)), prompts, SHIM["gen"],
        torch.device("cpu"), lambda _m: None, **kw)
    return res["generated_ids"]


def _dry_doc(arch, shape, out):
    from test_torch_dryrun import _doc

    return _doc(arch, DRY_SHAPES[shape], out, mesh={"dp": 2, "tp": 4},
                plan="fsdp_tp")


_RANKS = textwrap.dedent('''
    import json, os, sys
    sys.path.insert(0, {src!r})
    sys.path.insert(0, {tests!r})
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    import test_torch_mm_mesh as T
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding import plans as PL
    from repro_torch.tree import tree_leaves

    out = {{"train": {{}}, "grads": {{}}, "serve": {{}}}}
    meshes = {{s: make_local_mesh(*s, device_type="cpu")
               for s in ((2, 2), (1, 4), (4, 1))}}
    for arch in T.ARCHS:
        for dp, tp in T.MESHES[arch]:
            for plan in T.PLANS:
                losses, layout = T._train(arch, plan, meshes[(dp, tp)])
                out["train"][f"{{arch}}-{{plan}}-{{dp}}x{{tp}}"] = {{
                    "losses": losses, "layout": layout}}
        ref = T._grads(arch)
        top = max(float(g.abs().max()) for g in ref.values())
        for dp, tp in T.SERVE_MESHES:
            got = T._grads(arch, "fsdp_tp", meshes[(dp, tp)])
            out["grads"][f"{{arch}}-{{dp}}x{{tp}}"] = {{
                k: float((got[k] - ref[k]).abs().max()
                         / max(float(ref[k].abs().max()),
                               top if "['bk']" in k else 1e-30))
                for k in ref}}

    # the shim's cache as the decode ticks find it
    from repro_torch.train import steps as STEPS

    caches = []
    step = STEPS.make_serve_step

    def keep(model, mesh_ctx=None):
        inner = step(model, mesh_ctx)

        def serve_step(params, cache, *a):
            caches.append(cache)
            return inner(params, cache, *a)
        return serve_step

    STEPS.make_serve_step = keep
    prompts = np.load(sys.argv[2])
    plan = PL.make_plan("fsdp_tp")
    for arch in T.ARCHS:
        for dp, tp in T.SERVE_MESHES:
            mesh = meshes[(dp, tp)]
            caches.clear()
            streams = T._shim(arch, prompts[arch], mesh=mesh, plan=plan)
            cache = caches[-1]
            model = T._model(arch, f32=False)
            cfg = model.cfg
            shapes = model.init_cache(
                T.SHIM["batch"], cfg.n_patches + T.SHIM["prompt_len"]
                + T.SHIM["gen"], device="meta")
            specs = PL.cache_specs(plan, mesh, shapes)
            layout = all(isinstance(t, DTensor) and list(t.placements)
                         == PL.spec_placements(mesh, s)
                         for t, s in zip(tree_leaves(cache),
                                         tree_leaves(specs)))
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, (streams, layout))
            out["serve"][f"{{arch}}-{{dp}}x{{tp}}"] = {{
                "streams": streams,
                "same_on_every_rank": all(e[0] == streams for e in every),
                "layout_on_every_rank": all(e[1] for e in every),
                "specs": {{k: PL.spec_to_json(s)
                           for k, s in PL._flatten(specs)}}}}
    if dist.get_rank() == 0:
        with open(os.path.join(sys.argv[1], "ranks.json"), "w") as f:
            json.dump(out, f)
''')

_JAX = textwrap.dedent('''
    import inspect, json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, sys.argv[1])
    sys.path.insert(0, sys.argv[2])
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_reduced
    from repro.launch import serve as SV
    from repro.launch.mesh import make_local_mesh
    from repro.models import build_model
    from repro.optim.adamw import AdamW
    from repro.run import api
    from repro.sharding import plans as PL
    from repro.train import steps as ST
    import test_torch_mm_mesh as T
    from test_torch_dryrun import EQUAL_KEYS

    out = {"train": {}, "serve": {}, "dryrun": {},
           "shim_args": list(inspect.signature(
               SV._multimodal_benchmark).parameters)}
    for arch in T.ARCHS:
        flat = np.load(os.path.join(sys.argv[3], arch + ".npz"))
        params = {}
        for key in flat.files:
            node = params
            *head, last = key.split("/")
            for part in head:
                node = node.setdefault(part, {})
            node[last] = jnp.asarray(flat[key])
        model = build_model(T._cfg(arch, get_reduced))
        if arch == "whisper_tiny":
            model.act_dtype = jnp.float32
        else:
            embed = model.embed_tokens
            model.embed_tokens = lambda p, t, dtype=None, e=embed: e(
                p, t, jnp.float32)
        batch = {k: jnp.asarray(v) for k, v in T._batch(arch).items()}
        for dp, tp in T.MESHES[arch]:
            mesh = make_local_mesh(dp, tp)
            for name in T.PLANS:
                plan = PL.make_plan(name)
                opt = AdamW(lr=1e-3)
                state = {"params": params, "opt": opt.init(params),
                         "step": jnp.zeros((), jnp.int32)}
                sh, _ = PL.train_state_shardings(plan, mesh, model, opt)
                bsh = PL.batch_shardings(plan, mesh, batch)
                with mesh:
                    state = jax.device_put(state, sh)
                    step = jax.jit(ST.make_train_step(
                        model, opt, PL.mesh_context(plan, mesh)),
                        in_shardings=(sh, bsh), out_shardings=(sh, None))
                    rows = []
                    for _ in range(2):
                        state, m = step(state, jax.device_put(batch, bsh))
                        rows.append(float(m["loss"]))
                out["train"][f"{arch}-{name}-{dp}x{tp}"] = rows
        serve_model = build_model(T._cfg(arch, get_reduced))
        kw = dict(params=params, log=lambda _m: None, **T.SHIM)
        mesh = make_local_mesh(2, 2)
        out["serve"][arch] = {
            "plain": SV.serve_benchmark(serve_model, **kw)["generated_ids"],
            "plan": SV.serve_benchmark(serve_model, mesh=mesh,
                                       plan=PL.make_plan("fsdp_tp"),
                                       **kw)["generated_ids"]}
        for shape in T.DRY_SHAPES:
            res = api.execute_doc(T._dry_doc(arch, shape,
                                             sys.argv[4] + arch + shape),
                                  write_files=False)
            out["dryrun"][arch + "-" + shape] = {k: res[k]
                                                 for k in EQUAL_KEYS}
    with open(sys.argv[5], "w") as f:
        json.dump(out, f)
''')


def _jax_prompts(arch):
    """JAX's shim prompts (``jax.random.randint`` of ``seed + 1``)."""
    import jax

    return np.asarray(jax.random.randint(
        jax.random.PRNGKey(SHIM["seed"] + 1),
        (SHIM["batch"], SHIM["prompt_len"]), 3, _cfg(arch).vocab), np.int32)


@pytest.fixture(scope="module", autouse=True)
def _launch(tmp_path_factory):
    """The 4-rank launch and the JAX subprocess, started together before
    this module's first test."""
    from repro_torch.ckpt.format import flatten_with_paths

    out = tmp_path_factory.mktemp("mm_mesh")
    here = os.path.dirname(os.path.abspath(__file__))
    for arch in ARCHS:
        np.savez(out / f"{arch}.npz", **dict(flatten_with_paths(
            params_to_numpy(_init(arch)))))
    np.savez(out / "prompts.npz", **{a: _jax_prompts(a) for a in ARCHS})
    script = out / "ranks.py"
    script.write_text(_RANKS.format(src=SRC, tests=here))
    logs = {k: open(out / f"{k}.log", "w") for k in ("ranks", "jax")}
    procs = {
        "ranks": subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "4", str(script), str(out),
             str(out / "prompts.npz")], cwd=str(out),
            env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"),
            stdout=logs["ranks"], stderr=subprocess.STDOUT),
        "jax": subprocess.Popen(
            [sys.executable, "-c", _JAX, SRC, here, str(out),
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


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_and_shim_at_world_size_one(mesh1, arch):
    """Under ``fsdp_tp`` on a one-rank mesh a train step's losses and the
    shim's streams (``serve_benchmark``) ``==`` the unsharded runs'."""
    assert _train(arch, "fsdp_tp", mesh1, steps=2) == (
        _train(arch, steps=2)[0], True)
    model = _model(arch, f32=False)
    kw = dict(params=model.init(torch.Generator().manual_seed(0)),
              device="cpu", log=lambda _m: None, **SHIM)
    assert serve_benchmark(model, mesh=mesh1, plan=PL.make_plan("fsdp_tp"),
                           **kw)["generated_ids"] == \
        serve_benchmark(model, **kw)["generated_ids"]


# ---------------------------------------------------------------------------
# fake worlds, and JAX's full-width plan rules
# ---------------------------------------------------------------------------
def _jax_full_warnings(arch, name, sizes):
    """JAX's ``leaf_spec`` warnings of the full-width tree (``eval_shape``
    on no device) under ``name`` on a stand-in mesh of ``sizes``."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.models import build_model as jax_build_model
    from repro.sharding import plans as JPL
    from test_torch_plans import _FakeMesh

    model = jax_build_model(jax_get_config(arch))
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
@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_warnings_equal_jax(arch, sizes):
    """The full-width tree's warnings under ``fsdp_tp`` (``meta`` shapes)
    ``==`` JAX's: Whisper's 6 heads and its odd vocab replicated over a
    ``model`` axis of 4, LLaVA's 56 heads and 8 KV heads over none."""
    model = build_model(get_config(arch))
    shapes = model.init(MetaGenerator().manual_seed(0))
    grid = {"data": sizes[0], "model": sizes[1]}
    _, warns = PL.param_specs(PL.make_plan("fsdp_tp"), grid, shapes,
                              model.param_axes())
    assert warns == _jax_full_warnings(arch, "fsdp_tp", grid)
    if arch == "whisper_tiny" and sizes == (1, 4):
        assert "['embed']: vocab=51865 !% model 4 -> replicated" in warns


def _full_doc(tmp_path, arch, shape):
    return {"run": {"kind": "dryrun", "name": "m",
                    "output_dir": str(tmp_path)},
            "arch": {"component_key": "arch_config", "variant_key": arch},
            "shape": {"component_key": "shape", "variant_key": shape}}


@pytest.mark.parametrize("arch,shape", [("whisper_tiny", "train_4k"),
                                        ("llava_next_34b", "train_4k"),
                                        ("whisper_tiny", "decode_32k")])
def test_full_width_dryrun_on_256_fake_ranks(tmp_path, arch, shape):
    """Full width under the default plan, ``fsdp_tp``, on the production
    mesh's fake world of 256 ranks: ``model_flops_global`` ``==`` JAX's
    ``model_flops(cfg, shape)``, the warnings JAX's, argument bytes and
    collectives counted, no process group left.  A train batch's
    ``frames`` (f32, 256 x 1500 x 384) or ``patch_embeds`` (bf16, 256 x
    576 x 7168) are among its argument bytes."""
    from repro.configs import get_config as jax_get_config
    from repro.configs.shapes import SHAPES as JSHAPES
    from repro.telemetry.accounting import model_flops as jax_model_flops
    from repro_torch.run import api

    res = api.execute_doc(_full_doc(tmp_path, arch, shape), device="cpu",
                          log=lambda _m: None)
    assert res["plan"] == "fsdp_tp(dp=data; fsdp=data; tp=model)"
    assert res["chips"] == 256
    assert res["model_flops_global"] == jax_model_flops(
        jax_get_config(arch), JSHAPES[shape])[0]
    assert res["sharding_warnings"] == _jax_full_warnings(
        arch, "fsdp_tp", {"data": 16, "model": 16})
    if shape == "train_4k":
        cfg = get_config(arch)
        extra = (256 * 1500 * 384 * 4 if arch == "whisper_tiny"
                 else 256 * cfg.n_patches * cfg.d_model * 2)
        assert res["mem_argument_size_in_bytes"] > extra // 16
    assert res["collective_counts"]["all-gather"] > 0
    assert not dist.is_initialized()


def test_whisper_long_500k_is_jax_skip_record(tmp_path):
    """Whisper x ``long_500k`` returns JAX's skip record, before any
    process group."""
    from repro.configs import get_config as jax_get_config
    from repro.configs.shapes import SHAPES as JSHAPES
    from repro.launch.specs import supports_shape
    from repro_torch.run import api

    res = api.execute_doc(_full_doc(tmp_path, "whisper_tiny", "long_500k"),
                          device="cpu", log=lambda _m: None)
    ok, why = supports_shape(jax_get_config("whisper_tiny"),
                             JSHAPES["long_500k"])
    assert not ok and res["skipped"] == why
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# 4 gloo ranks and JAX
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(_launch):
    """The port's one-device curves and shims, in this process, then both
    launches' results."""
    out, procs = _launch
    prompts = np.load(out / "prompts.npz")
    one = {a: {"train": _train(a)[0], "shim": _shim(a, prompts[a])}
           for a in ARCHS}
    for k, p in procs.items():
        assert p.wait(timeout=900) == 0, \
            (out / f"{k}.log").read_text()[-4000:]
    with open(out / "ranks.json") as f:
        got = json.load(f)
    with open(out / "jax.json") as f:
        jax_out = json.load(f)
    return {"ranks": got, "one": one, "jax": jax_out,
            "prompts": {a: prompts[a] for a in ARCHS}}


_CASES = [(a, p, m) for a in ARCHS for m in MESHES[a] for p in PLANS]


@pytest.mark.parametrize("arch,plan,mesh", _CASES,
                         ids=[f"{a.split('_')[0]}-{p}-{m[0]}x{m[1]}"
                              for a, p, m in _CASES])
def test_train_steps_under_a_plan(runs, arch, plan, mesh):
    """3 steps on 4 ranks within ``LOSS_TOL`` of the one-device steps,
    every leaf and the batch's extras laid out as the plan says; the first
    2 within ``JAX_LOSS_TOL`` of JAX's steps under the same plan and
    mesh."""
    key = f"{arch}-{plan}-{mesh[0]}x{mesh[1]}"
    row = runs["ranks"]["train"][key]
    assert row["layout"]
    assert row["losses"][2] < row["losses"][0]
    for got, want in zip(row["losses"], runs["one"][arch]["train"]):
        assert abs(got - want) <= LOSS_TOL * want, (row, runs["one"][arch])
    for got, want in zip(row["losses"], runs["jax"]["train"][key]):
        assert abs(got - want) <= JAX_LOSS_TOL * want, key


@pytest.mark.parametrize("mesh", SERVE_MESHES, ids=["2x2", "1x4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_equal_the_one_device_ones(runs, arch, mesh):
    """Under ``fsdp_tp`` every leaf's gradient within ``GRAD_TOL`` of the
    one-device one: on ``(2, 2)`` the heads split over ``model``, on ``(1,
    4)`` Whisper's 6 heads replicated (LLaVA's 4 split) and the batch
    whole on every rank."""
    errs = runs["ranks"]["grads"][f"{arch}-{mesh[0]}x{mesh[1]}"]
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])


def _jax_logits(arch, prompt, prefix):
    """JAX's logits after ``prompt + prefix`` through its model's prefill
    (on zero frames or zero patches, as the shims feed) and decode steps:
    LLaVA's at positions past its patches."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced as jax_get_reduced
    from repro.models import build_model as jax_build_model

    cfg = _cfg(arch, jax_get_reduced)
    jm = jax_build_model(cfg)
    params = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(
        _model(arch, f32=False).init(torch.Generator().manual_seed(0))))
    batch = {"tokens": jnp.asarray([prompt], jnp.int32)}
    if arch == "whisper_tiny":
        batch["frames"] = jnp.zeros((1, cfg.encoder_frames, cfg.d_model))
    else:
        batch["patch_embeds"] = jnp.zeros((1, cfg.n_patches, cfg.d_model))
    start = cfg.n_patches + len(prompt)
    logits, cache = jm.prefill(params, batch,
                               max_len=start + len(prefix) + 1)
    for i, t in enumerate(prefix):
        logits, cache = jm.decode_step(params, cache,
                                       jnp.asarray([t], jnp.int32),
                                       jnp.asarray([start + i], jnp.int32))
    return np.asarray(logits[0], np.float32)


def _near(arch, prompts, got, want):
    """Each stream of ``got`` equals ``want``'s or parts where JAX's top-2
    margin is within ``LOGIT_TOL``; most are equal."""
    same = 0
    for prompt, a, b in zip(prompts, got, want):
        assert len(a) == len(b)
        if a == b:
            same += 1
            continue
        i = next(j for j in range(len(a)) if a[j] != b[j])
        logits = _jax_logits(arch, [int(t) for t in prompt], b[:i])
        assert float(logits.max() - logits[a[i]]) <= LOGIT_TOL, (a, b)
    assert same >= len(want) // 2


@pytest.mark.parametrize("mesh", SERVE_MESHES, ids=["2x2", "1x4"])
@pytest.mark.parametrize("arch", ARCHS)
def test_shim_under_fsdp_tp(runs, arch, mesh):
    """Every rank draws the same greedy streams; the cache's leaves have
    ``cache_specs``' placements on every rank (on ``(1, 4)`` the caches'
    sequence over ``model``: Whisper's cross-attention softmax then spans
    ranks); the streams equal the one-device shim's or part at a near-tie
    of JAX's."""
    row = runs["ranks"]["serve"][f"{arch}-{mesh[0]}x{mesh[1]}"]
    assert row["same_on_every_rank"] and row["layout_on_every_rank"]
    if mesh == (1, 4):
        assert all(s[2] == "model" for s in row["specs"].values())
    _near(arch, runs["prompts"][arch], row["streams"],
          runs["one"][arch]["shim"])


@pytest.mark.parametrize("arch", ARCHS)
def test_multimodal_shim_shards_where_jax_drops_the_plan(runs, arch):
    """ROADMAP C9: JAX's ``_multimodal_benchmark`` takes no ``mesh`` or
    ``plan``, so its ``serve_benchmark`` under ``fsdp_tp`` returns the
    unsharded run's streams; the port's shim shards the same serve.
    Whisper's sharded streams equal JAX's shim's or part at a near-tie of
    JAX's; LLaVA's equal the port's own unsharded shim (JAX's VLM shim
    decodes over its patches alone, ROADMAP C, so its streams are another
    function)."""
    jax_serve = runs["jax"]["serve"][arch]
    assert "mesh" not in runs["jax"]["shim_args"]
    assert "plan" not in runs["jax"]["shim_args"]
    assert jax_serve["plan"] == jax_serve["plain"]
    got = runs["ranks"]["serve"][f"{arch}-2x2"]["streams"]
    want = (jax_serve["plain"] if arch == "whisper_tiny"
            else runs["one"][arch]["shim"])
    _near(arch, runs["prompts"][arch], got, want)


@pytest.mark.parametrize("shape", list(DRY_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_dryrun_matches_jax(tmp_path, runs, arch, shape):
    """The port's dryrun on a fake world of 8 against JAX's on 8 forced
    devices, ``fsdp_tp`` on ``(2, 4)``: ``EQUAL_KEYS`` ``==``, among them
    the argument bytes (a train batch's frames or patches counted)."""
    from repro_torch.run import api
    from test_torch_dryrun import EQUAL_KEYS

    res = api.execute_doc(_dry_doc(arch, shape, str(tmp_path)),
                          device="cpu", log=lambda _m: None)
    want = runs["jax"]["dryrun"][f"{arch}-{shape}"]
    for key in EQUAL_KEYS:
        assert res[key] == want[key], (key, res[key], want[key])
    assert not dist.is_initialized()
