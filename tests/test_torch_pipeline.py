"""The GPipe schedule of the port (``repro_torch.sharding.pipeline``)
against JAX's (``repro.sharding.pipeline``), on the CPU.

JAX's side runs as its own tests run it (``tests/test_pipeline.py``): in a
subprocess with ``--xla_force_host_platform_device_count=8``, on numpy
``W``/``x`` this module draws.  The port runs them stage-local in this
process and pipe-sharded on 8 gloo ranks (``python -m
torch.distributed.run --nproc-per-node 8``, one launch, a ``(pipe 4, data
2)`` mesh).  The cases:

- the schedule helpers (``stage_split``, ``microbatch``, ``unmicrobatch``)
  and their errors ``==`` JAX's;
- ``gpipe_apply`` (4 stages, 8 microbatches) and ``pipeline_apply`` (4
  stages of 2 layers, 4 microbatches, a dict carry with an aux leaf),
  value and gradient, in both modes, within JAX's own tolerances (1e-5 on
  the value, 1e-4 on the gradient);
- ROADMAP C8: JAX's pipelined backbone sums each microbatch's Switch
  balance loss, so its ``router_lb`` under ``pp2_fsdp`` is not its
  unpipelined one; the port's is (f32 activations, ``C8_TOL``);
- the pipelined backbone's refusals (the hybrid, a stack not divisible
  into the stages) with JAX's words.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.models import base as B
from repro_torch.models import build_model
from repro_torch.sharding import pipeline as PIPE
from repro_torch.train import steps as ST

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
#: JAX's own bounds (``tests/test_pipeline.py``): value, gradient
VALUE_TOL, GRAD_TOL = 1e-5, 1e-4
#: the pipe-sharded bf16 carry's gradients against the stage-local ones
#: (the same products; bf16 sums of the microbatches' contributions)
MIXED_GRAD_TOL = 1e-2
#: the port's pipelined ``router_lb`` against its unpipelined one, relative,
#: f32 activations: the microbatches' router statistics add up to the
#: batch's, the sums taken in another order (1e-7 seen)
C8_TOL = 1e-5
GS, GM, GMB, D = 4, 8, 2, 16          # gpipe: stages, microbatches, rows, width
PS, PL_, PM = 4, 8, 4                 # pipeline_apply: stages, layers, micro


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "gW": (rng.standard_normal((GS, D, D)) * 0.3).astype(np.float32),
        "gx": rng.standard_normal((GM, GMB, D)).astype(np.float32),
        "pW": (rng.standard_normal((PL_, D, D)) * 0.3).astype(np.float32),
        "px": rng.standard_normal((PM * GMB, D)).astype(np.float32),
    }


_JAX = textwrap.dedent('''
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, sys
    sys.path.insert(0, {src!r})
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.sharding.pipeline import (gpipe_apply, microbatch,
                                         pipeline_apply, stage_split,
                                         unmicrobatch)
    inp = dict(np.load(sys.argv[1]))
    out = {{}}
    mesh4 = Mesh(np.asarray(jax.devices()[:4]), ("pipe",))
    gW, gx = jnp.asarray(inp["gW"]), jnp.asarray(inp["gx"])

    def stage_fn(w, x):
        return jnp.tanh(x @ w)

    def gloss(W):
        return jnp.sum(gpipe_apply(stage_fn, W, gx, mesh4) ** 2)

    with mesh4:
        out["g_out"] = np.asarray(jax.jit(
            lambda W: gpipe_apply(stage_fn, W, gx, mesh4))(gW))
        out["g_grad"] = np.asarray(jax.jit(jax.grad(gloss))(gW))

    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("pipe", "data"))
    pW, px = jnp.asarray(inp["pW"]), jnp.asarray(inp["px"])

    def pstage(w_stage, carry):
        def body(c, w):
            return (jnp.tanh(c[0] @ w), c[1] + jnp.sum(c[0] ** 2)), None
        (y, aux), _ = jax.lax.scan(body, (carry["x"], carry["aux"]), w_stage)
        return {{"x": y, "aux": aux}}

    def ploss(W, x):
        micro = {{"x": microbatch(x, {pm}),
                  "aux": jnp.zeros(({pm},), jnp.float32)}}
        o = pipeline_apply(pstage, stage_split(W, {ps}), micro, mesh,
                           dp_axes=("data",))
        return jnp.sum(unmicrobatch(o["x"]) ** 2) + jnp.sum(o["aux"])

    with mesh:
        Wd = jax.device_put(pW, NamedSharding(mesh, P("pipe")))
        xd = jax.device_put(px, NamedSharding(mesh, P("data")))
        v, g = jax.jit(jax.value_and_grad(ploss))(Wd, xd)
    out["p_value"], out["p_grad"] = np.asarray(v), np.asarray(g)

    # ROADMAP C8: reduced DeepSeekMoE, 2 dense + 2 MoE layers
    from repro.configs import get_reduced
    from repro.launch.mesh import make_local_mesh
    from repro.models import build_model
    from repro.sharding import plans as PL
    from repro.train.steps import compute_loss
    cfg = get_reduced("deepseek_moe_16b")
    cfg = cfg.with_(n_layers=4, moe=dataclasses.replace(cfg.moe,
                                                        n_dense_layers=2))
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (8, 32), 0, cfg.vocab)
    batch = {{"tokens": toks, "labels": jnp.roll(toks, -1, 1)}}
    _, aux = jax.jit(lambda p, b: compute_loss(model, p, b))(params, batch)
    out["c8_none"] = np.asarray([aux["ce"], aux["router_lb"]])
    mesh = make_local_mesh(4, 1, 2)
    plan = PL.make_plan("pp2_fsdp")
    ctx = PL.mesh_context(plan, mesh)
    sh, _ = PL.param_shardings(plan, mesh, jax.eval_shape(
        model.init, jax.random.PRNGKey(0)), model.param_axes())
    with mesh:
        _, aux = jax.jit(lambda p, b: compute_loss(model, p, b, ctx))(
            jax.device_put(params, sh), batch)
    out["c8_pp2"] = np.asarray([aux["ce"], aux["router_lb"]])
    out["c8_tokens"] = np.asarray(toks)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out["c8_param/" + "/".join(str(p.key) for p in path)] = np.asarray(
            leaf)
    np.savez(sys.argv[2], **out)
''')


def _unflatten_params(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, last = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """JAX's gpipe, SPMD pipeline and C8 figures on this module's inputs,
    in one subprocess with 8 forced host devices."""
    d = tmp_path_factory.mktemp("jax_pipe")
    np.savez(d / "in.npz", **_inputs())
    script = _JAX.format(src=SRC, ps=PS, pm=PM)
    proc = subprocess.run([sys.executable, "-c", script, str(d / "in.npz"),
                           str(d / "out.npz")], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = dict(np.load(d / "out.npz"))
    params = _unflatten_params({k[len("c8_param/"):]: v for k, v in out.items()
                                if k.startswith("c8_param/")})
    out["dir"] = d
    out["c8_params"] = params
    return out


def _c8_model():
    """Reduced DeepSeekMoE with 2 dense + 2 MoE layers, f32 activations."""
    import dataclasses

    cfg = get_reduced("deepseek_moe_16b")
    cfg = cfg.with_(n_layers=4, moe=dataclasses.replace(cfg.moe,
                                                        n_dense_layers=2))
    model = build_model(cfg)
    embed = model.embed_tokens
    model.embed_tokens = lambda p, t: embed(p, t, dtype=torch.float32)
    return model


# ---------------------------------------------------------------------------
# stage-local, in this process
# ---------------------------------------------------------------------------
def _outcome(fn):
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 - compared by type and words
        return ("error", type(e).__name__, str(e))
    return ("ok", tuple(np.shape(v) for v in out.values()))


def test_schedule_helpers_equal_jax():
    from repro.sharding import pipeline as JPIPE

    x = np.arange(24.0, dtype=np.float32).reshape(6, 4)
    w = np.arange(8.0, dtype=np.float32).reshape(8, 1)
    for n in (1, 2, 3, 4, 6):
        assert _outcome(lambda: PIPE.microbatch({"x": torch.from_numpy(x)},
                                                n)) == \
            _outcome(lambda: JPIPE.microbatch({"x": x}, n))
        assert _outcome(lambda: PIPE.stage_split({"w": torch.from_numpy(w)},
                                                 n)) == \
            _outcome(lambda: JPIPE.stage_split({"w": w}, n))
    m = PIPE.microbatch({"x": torch.from_numpy(x)}, 3)
    assert torch.equal(PIPE.unmicrobatch(m)["x"], torch.from_numpy(x))
    np.testing.assert_array_equal(m["x"].numpy(),
                                  np.asarray(JPIPE.microbatch({"x": x}, 3)["x"]))


def _gstage(w, x):
    return torch.tanh(x @ w)


def _pstage(w_stage, carry):
    y, aux = carry["x"], carry["aux"]
    for w in w_stage:
        aux = aux + torch.sum(y ** 2)
        y = torch.tanh(y @ w)
    return {"x": y, "aux": aux}


def test_gpipe_apply_stage_local_matches_jax(jax_ref):
    inp = _inputs()
    W = torch.from_numpy(inp["gW"]).requires_grad_(True)
    out = PIPE.gpipe_apply(_gstage, W, torch.from_numpy(inp["gx"]))
    (out ** 2).sum().backward()
    assert np.abs(out.detach().numpy() - jax_ref["g_out"]).max() < VALUE_TOL
    assert np.abs(W.grad.numpy() - jax_ref["g_grad"]).max() < GRAD_TOL
    with pytest.raises(ValueError, match="at least one microbatch"):
        PIPE.gpipe_apply(_gstage, W, torch.zeros((0, GMB, D)))


def test_pipeline_apply_stage_local_matches_jax(jax_ref):
    inp = _inputs()
    W = torch.from_numpy(inp["pW"]).requires_grad_(True)
    micro = {"x": PIPE.microbatch(torch.from_numpy(inp["px"]), PM),
             "aux": torch.zeros(PM)}
    o = PIPE.pipeline_apply(_pstage, PIPE.stage_split(W, PS), micro)
    v = (PIPE.unmicrobatch(o["x"]) ** 2).sum() + o["aux"].sum()
    v.backward()
    want = float(jax_ref["p_value"])
    assert abs(float(v) - want) / abs(want) < VALUE_TOL
    assert np.abs(W.grad.numpy() - jax_ref["p_grad"]).max() < GRAD_TOL


def _c8_batch(tokens):
    return {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}


def _c8_losses(model, params, batch, ctx):
    with torch.no_grad():
        _, aux = ST.compute_loss(model, params, batch, ctx)
    return tuple(float(v.full_tensor() if B.is_dtensor(v) else v)
                 for v in (aux["ce"], aux["router_lb"]))


def test_pipelined_router_lb_is_the_batch_s_not_jax_s(jax_ref):
    """ROADMAP C8.  JAX: under ``pp2_fsdp`` (4 x 1 x 2, 4 microbatches)
    its ``router_lb`` is several times its unpipelined one, its ``ce`` the
    same.  The port's pipelined backbone (stage-local here, 2 stages of 4
    and of 8 microbatches) gives its unpipelined ``router_lb`` within
    ``C8_TOL``; pipe-sharded, ``tests/test_torch_pp_train.py``'s MoE
    curves hold it to the one-device curve."""
    j_none, j_pp2 = jax_ref["c8_none"], jax_ref["c8_pp2"]
    assert abs(j_pp2[0] - j_none[0]) < 1e-3 * j_none[0]
    assert j_pp2[1] > 3 * j_none[1], (j_none, j_pp2)
    model = _c8_model()
    params = params_from_jax(jax_ref["c8_params"])
    tokens = torch.from_numpy(jax_ref["c8_tokens"]).long()
    ce, lb = _c8_losses(model, params, _c8_batch(tokens), None)
    assert abs(lb - float(j_none[1])) < 1e-3 * float(j_none[1])
    for pp, n_micro in ((2, 4), (2, 8)):
        got = _c8_losses(model, params, _c8_batch(tokens),
                         B.MeshContext(pp=pp, n_micro=n_micro))
        assert abs(got[0] - ce) <= 1e-6 * ce, (pp, got, ce)
        assert abs(got[1] - lb) <= C8_TOL * lb, (pp, got, lb)


def test_pipelined_backbone_refusals_equal_jax():
    from repro.configs import get_reduced as jax_get_reduced
    from repro.models import build_model as jax_build_model

    ctx = B.MeshContext(pp=3)
    x = torch.zeros((2, 4, 8))
    pos = torch.arange(4)
    for arch in ("zamba2_2p7b", "qwen1p5_0p5b"):
        model = build_model(get_reduced(arch))
        jm = jax_build_model(jax_get_reduced(arch))
        with pytest.raises(ValueError) as got:
            model.backbone({}, x, pos, ctx)

        class JCtx:
            pp, pipe_axis = 3, "pipe"

        with pytest.raises(ValueError) as want:
            jm.backbone({}, x.numpy(), pos.numpy(), JCtx())
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# pipe-sharded, on 8 gloo ranks
# ---------------------------------------------------------------------------
_RANKS = textwrap.dedent('''
    import json, os, sys
    sys.path.insert(0, {src!r})
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh, pipe_of
    from repro_torch.sharding import pipeline as PIPE
    sys.path.insert(0, {tests!r})
    import test_torch_pipeline as T

    d = sys.argv[1]
    inp = T._inputs()
    mesh = make_local_mesh(2, 1, 4, device_type="cpu")   # pipe 4 x data 2
    pipe = pipe_of(mesh, "pipe")
    s = pipe.rank
    out = {{}}

    def gather(t):
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, (s, t.tolist()))
        return [v for _, v in sorted(dict(got).items())]

    W = torch.from_numpy(inp["gW"][s:s + 1]).requires_grad_(True)
    g = PIPE.gpipe_apply(T._gstage, W, torch.from_numpy(inp["gx"]), pipe)
    (g ** 2).sum().backward()
    out["g_out"] = g.detach().tolist()
    out["g_grad"] = [row[0] for row in gather(W.grad)]

    per = T.PL_ // T.PS
    W = torch.from_numpy(inp["pW"][s * per:(s + 1) * per]).requires_grad_(True)
    micro = {{"x": PIPE.microbatch(torch.from_numpy(inp["px"]), T.PM),
              "aux": torch.zeros(T.PM)}}
    o = PIPE.pipeline_apply(T._pstage, W, micro, pipe)
    v = (PIPE.unmicrobatch(o["x"]) ** 2).sum() + o["aux"].sum()
    v.backward()
    out["p_value"] = float(v)
    out["p_grad"] = [r for blk in gather(W.grad) for r in blk]

    # a carry of two widths: bf16 activations beside f32 statistics
    import torch.distributed._functional_collectives as FC
    sent, a2a = [], FC.all_to_all_single

    def recorded(buf, *args, **kw):
        sent.append((str(buf.dtype), buf.numel()))
        return a2a(buf, *args, **kw)

    def mixed(w_stage, carry):
        y, aux = carry["x"], carry["aux"]
        for w in w_stage:
            aux = aux + torch.sum(y.float() ** 2)
            y = torch.tanh(y @ w.to(y.dtype))
        return {{"x": y, "aux": aux}}

    def mixed_value(o):
        return (PIPE.unmicrobatch(o["x"]).float() ** 2).sum() + o["aux"].sum()

    xb = PIPE.microbatch(torch.from_numpy(inp["px"]).bfloat16(), T.PM)
    W = torch.from_numpy(inp["pW"][s * per:(s + 1) * per]).requires_grad_(True)
    FC.all_to_all_single = recorded
    try:
        v = mixed_value(PIPE.pipeline_apply(
            mixed, W, {{"x": xb, "aux": torch.zeros(T.PM)}}, pipe))
        n_fwd = len(sent)
        v.backward()
    finally:
        FC.all_to_all_single = a2a
    Wl = torch.from_numpy(inp["pW"]).requires_grad_(True)
    vl = mixed_value(PIPE.pipeline_apply(
        mixed, PIPE.stage_split(Wl, T.PS),
        {{"x": xb, "aux": torch.zeros(T.PM)}}))
    vl.backward()
    out["m_value"] = [float(v), float(vl)]
    out["m_grad"] = float((W.grad - Wl.grad[s * per:(s + 1) * per])
                          .abs().max() / Wl.grad.abs().max())
    out["m_sent"] = [sent[:n_fwd], sent[n_fwd:]]

    if dist.get_rank() == 0:
        with open(os.path.join(d, "ranks.json"), "w") as f:
            json.dump(out, f)
''')


@pytest.fixture(scope="module")
def sharded(jax_ref):
    """One 8-rank launch: both engines pipe-sharded."""
    d = jax_ref["dir"]
    script = d / "ranks.py"
    script.write_text(_RANKS.format(src=SRC, tests=os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "8", str(script), str(d)], cwd=str(d), env=env,
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(d / "ranks.json") as f:
        return json.load(f)


def test_gpipe_apply_pipe_sharded_matches_jax(jax_ref, sharded):
    assert np.abs(np.asarray(sharded["g_out"]) - jax_ref["g_out"]).max() \
        < VALUE_TOL
    assert np.abs(np.asarray(sharded["g_grad"]) - jax_ref["g_grad"]).max() \
        < GRAD_TOL


def test_pipeline_apply_pipe_sharded_matches_jax(jax_ref, sharded):
    want = float(jax_ref["p_value"])
    assert abs(sharded["p_value"] - want) / abs(want) < VALUE_TOL
    assert np.abs(np.asarray(sharded["p_grad"]) - jax_ref["p_grad"]).max() \
        < GRAD_TOL


def test_pipe_shift_sends_each_leaf_at_its_own_width(sharded):
    """A carry of bf16 activations beside f32 statistics crosses the pipe
    in one ``all_to_all_single`` a tick, forward and backward, of exactly
    each leaf's bytes at its own width (each padded to 16 bytes); the
    pipe-sharded value ``==`` the stage-local one, the gradients within
    ``MIXED_GRAD_TOL`` (bf16: relative to the largest element)."""
    fwd, bwd = sharded["m_sent"]
    per_shift = -(-GMB * D * 2 // 16) * 16 + 16
    assert len(fwd) == len(bwd) == PS + PM - 2
    assert all(sent == ["torch.uint8", per_shift] for sent in fwd + bwd)
    got, want = sharded["m_value"]
    assert got == want
    assert sharded["m_grad"] < MIXED_GRAD_TOL
