"""The port's training step against the JAX package, on the CPU.

Losses, the optimizer and its schedules, the two kernel wrappers' gradients
(their ``autograd.Function`` backwards), and one ``make_train_step`` of
reduced Qwen1.5-0.5B (flash path on and off) and reduced Mamba2-780M from
JAX's params, carried across by ``repro_torch.bridge``.  Inputs are made
with numpy from a seed.  The JAX side runs its Pallas kernels in interpret
mode, as ``tests/test_kernels.py`` does; the port's wrappers run their plain
versions here (the tensors lie on the CPU) through the same Function the
card runs.

Tolerances:

- losses in f32 (``CE_TOL`` 1e-6 of the loss): logsumexp and a gather of
  the same f32 logits, whose sums run in other orders.
- AdamW (``ADAM_TOL`` 1e-5, as ``tests/test_optim.py``): the same f32
  update; ``pow`` and ``sqrt`` may differ in the last bit.
- the kernel gradients (``KERNEL_GRAD_TOL`` 2e-4 in f32, as
  ``tests/test_kernels.py``): both recompute the same plain f32 function.
- one train step with bf16 activations (``STEP_GRAD_TOL`` 5e-2 of each
  leaf's largest gradient, ``STEP_LOSS_TOL`` 3e-3 of the loss): XLA and
  eager PyTorch round the bf16 activations and their gradients at other
  places (XLA keeps fused chains in f32), and a leaf's gradient sums such
  differences over the batch; 2.8e-2 is the largest seen here.  The same
  step with f32 activations agrees to 1e-5 of each leaf's largest gradient
  (``STEP_F32_TOL`` 1e-4), which shows the bf16 spread is rounding only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from unittest import mock

import repro.optim.schedules as JSCHED
import repro_torch.optim.schedules as PSCHED
from repro.configs import get_reduced as jax_get_reduced
from repro.kernels.flash.ops import flash_attention as jax_flash
from repro.kernels.ssd.ops import ssd as jax_ssd
from repro.models import build_model as jax_build_model
from repro.models import common as JC
from repro.optim.adamw import AdamW as JaxAdamW
from repro.train import steps as JST
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.kernels.flash.ops import flash_attention
from repro_torch.kernels.flash.ref import attention_ref
from repro_torch.kernels.ssd.ops import ssd_scan
from repro_torch.kernels.ssd.ref import ssd_chunked
from repro_torch.models import build_model
from repro_torch.models import common as PC
from repro_torch.optim.adamw import AdamW, global_norm
from repro_torch.train import steps as PST
from repro_torch.tree import tree_leaves, tree_map

CE_TOL = 1e-6
ADAM_TOL = 1e-5
KERNEL_GRAD_TOL = 2e-4
STEP_GRAD_TOL = 5e-2
STEP_LOSS_TOL = 3e-3
STEP_F32_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Reduced models: their ops are far too small to split across threads,
    and the suite's parallel workers share the host's cores.  One thread
    for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_tree(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a), tree)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fn", ["sharded_cross_entropy",
                                "softmax_cross_entropy"])
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(fn, masked):
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 16, 97))).astype(np.float32)
    labels = rng.integers(0, 97, (2, 16)).astype(np.int32)
    mask = (rng.random((2, 16)) < 0.6).astype(np.float32) if masked else None
    want = float(getattr(JC, fn)(jnp.asarray(logits), jnp.asarray(labels),
                                 None if mask is None else jnp.asarray(mask)))
    # the port's loss takes bf16 logits as the model gives them, in f32
    got = float(getattr(PC, fn)(_t(logits), _t(labels),
                                None if mask is None else _t(mask)))
    assert abs(got - want) <= CE_TOL * abs(want)


def test_cross_entropy_of_bf16_logits_is_f32():
    logits = torch.randn(2, 4, 8, generator=torch.Generator().manual_seed(0))
    labels = torch.zeros((2, 4), dtype=torch.int64)
    out = PC.sharded_cross_entropy(logits.bfloat16(), labels)
    assert out.dtype == torch.float32
    assert float(out) == float(PC.sharded_cross_entropy(
        logits.bfloat16().float(), labels))


# ---------------------------------------------------------------------------
# optimizer and schedules
# ---------------------------------------------------------------------------
def _opt_tree(rng):
    """Stacked [L, ...] leaves beside unstacked ones, as in a model."""
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"blocks": {"norm": f(3, 8), "bias": f(3, 2, 4), "w": f(3, 8, 8)},
            "final_norm": f(8), "embed": f(16, 8)}


@pytest.mark.parametrize("grad_clip", [0.0, 1.0])
@pytest.mark.parametrize("master", [False, True])
def test_adamw_matches_jax(grad_clip, master):
    rng = np.random.default_rng(1)
    params = _opt_tree(rng)
    grads = [_opt_tree(rng) for _ in range(3)]
    kw = dict(lr=None, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
              grad_clip=grad_clip, master_weights=master)
    jopt = JaxAdamW(**dict(kw, lr=JSCHED.warmup_cosine(1e-2, 2, 10)))
    popt = AdamW(**dict(kw, lr=PSCHED.warmup_cosine(1e-2, 2, 10)))
    cast = (lambda a: a.astype(jnp.bfloat16)) if master else (lambda a: a)
    jp = jax.tree_util.tree_map(cast, _jax_tree(params))
    pp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    js, ps = jopt.init(jp), popt.init(pp)
    for g in grads:
        jp, js = jopt.update(_jax_tree(g), js, jp)
        pp, ps = popt.update(tree_map(_t, g), ps, pp)
    assert int(ps["count"]) == int(js["count"]) == 3
    want = jax.tree_util.tree_leaves(js["master"] if master else jp)
    got = tree_leaves(ps["master"] if master else pp)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.float().numpy(), _np(a), atol=ADAM_TOL,
                                   rtol=0)
    for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(pp)):
        assert b.dtype == (torch.bfloat16 if master else torch.float32)
        # bf16 params are the f32 masters rounded once, on both sides
        np.testing.assert_allclose(b.float().numpy(), _np(a),
                                   atol=ADAM_TOL + (2e-2 if master else 0),
                                   rtol=0)
    for key in ("m", "v"):
        for a, b in zip(jax.tree_util.tree_leaves(js[key]),
                        tree_leaves(ps[key])):
            np.testing.assert_allclose(b.numpy(), _np(a), atol=ADAM_TOL,
                                       rtol=0)


def test_adamw_decays_stacked_norms_not_final_norm():
    """JAX's rule ``ndim >= 2`` acts on the stacked leaves: a per-layer norm
    ``[L, D]`` decays, the final norm ``[D]`` does not."""
    opt = AdamW(lr=1e-2, weight_decay=1.0, grad_clip=0.0)
    params = {"blocks": {"scale": torch.ones(2, 4)}, "final_norm": torch.ones(4)}
    zero = tree_map(torch.zeros_like, params)
    new, state = opt.update(zero, opt.init(params), params)
    # the update writes ``params`` in place: compare with the values before
    assert torch.all(new["blocks"]["scale"] < 1)
    assert torch.equal(new["final_norm"], torch.ones(4))
    assert float(global_norm(state["m"])) == 0.0


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)),
    ("warmup_cosine", (1e-3, 5, 50, 0.1)),
    ("wsd", (1e-3, 5, 50, 0.2)),
])
def test_schedules_match_jax(name, args):
    jf, pf = getattr(JSCHED, name)(*args), getattr(PSCHED, name)(*args)
    for count in (0, 1, 3, 5, 6, 20, 39, 40, 41, 49, 50, 60):
        want = float(jf(jnp.asarray(count, jnp.int32)))
        got = pf(torch.tensor(count, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * max(abs(want), 1e-3), count


# ---------------------------------------------------------------------------
# the kernel wrappers' autograd Functions
# ---------------------------------------------------------------------------
def _flash_inputs():
    """tests/test_kernels.py:104-116's shapes, made with numpy."""
    rng = np.random.default_rng(3)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return f(1, 128, 4, 32), f(1, 128, 2, 32), f(1, 128, 2, 32)


def test_flash_function_grads_match_jax_and_autodiff():
    q, k, v = _flash_inputs()
    want = jax.grad(lambda q, k, v: jnp.sum(jax_flash(
        q, k, v, block_q=64, block_kv=64) ** 2), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    ins = [_t(a).requires_grad_(True) for a in (q, k, v)]
    out = flash_attention(*ins)
    got = torch.autograd.grad(torch.sum(out ** 2), ins)
    ref_ins = [_t(a).requires_grad_(True) for a in (q, k, v)]
    plain = torch.autograd.grad(torch.sum(attention_ref(*ref_ins) ** 2),
                                ref_ins)
    for w, g, p in zip(want, got, plain):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=KERNEL_GRAD_TOL)
        np.testing.assert_allclose(g.numpy(), p.numpy(), atol=KERNEL_GRAD_TOL)


def _ssd_inputs():
    """tests/test_kernels.py:118-129's shapes, made with numpy."""
    rng = np.random.default_rng(4)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(1, 64, 2, 16), np.log1p(np.exp(f(1, 64, 2))),
            -np.exp(0.3 * f(2)), 0.3 * f(1, 64, 1, 8), 0.3 * f(1, 64, 1, 8),
            np.ones((2,), np.float32))


def test_ssd_function_grads_match_jax():
    args = _ssd_inputs()
    want = jax.grad(lambda *a: jnp.sum(jax_ssd(*a, chunk=32) ** 2),
                    argnums=tuple(range(6)))(*map(jnp.asarray, args))
    ins = [_t(a).requires_grad_(True) for a in args]
    y, _ = ssd_scan(*ins, chunk=32)
    got = torch.autograd.grad(torch.sum(y ** 2), ins)
    for w, g in zip(want, got):
        scale = max(float(np.abs(_np(w)).max()), 1.0)
        np.testing.assert_allclose(g.numpy(), _np(w),
                                   atol=KERNEL_GRAD_TOL * scale)


def test_kernel_outputs_carry_the_function_grad_fn():
    q, k, v = (_t(a).requires_grad_(True) for a in _flash_inputs())
    assert type(flash_attention(q, k, v).grad_fn).__name__ == \
        "_FlashAttentionBackward"
    ins = [_t(a).requires_grad_(True) for a in _ssd_inputs()]
    y, h = ssd_scan(*ins, chunk=32)
    assert type(y.grad_fn).__name__ == "_SSDScanBackward"
    assert not h.requires_grad            # JAX's ssd returns y only
    with torch.no_grad():                  # serving: no graph
        assert flash_attention(q, k, v).grad_fn is None


def test_ssd_gradients_stay_finite_where_the_chunk_decay_overflows():
    """Within a chunk, exp(Sa_i - Sa_j) above the diagonal overflows once the
    decay passes ~88; JAX's ``ssd_chunked`` masks after the exp and its
    dt and A gradients are then NaN (0 * inf).  The port masks before the
    exp: the same forward, finite gradients that match JAX's where JAX's
    are finite."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 128, 2, 8)).astype(np.float32)
    dt = np.ones((1, 128, 2), np.float32)
    A = np.asarray([-0.5, -16.0], np.float32)     # head 1 decays by 2032
    Bm = rng.standard_normal((1, 128, 1, 4)).astype(np.float32)
    Cm = rng.standard_normal((1, 128, 1, 4)).astype(np.float32)
    D = np.ones((2,), np.float32)
    from repro.models.ssm import ssd_chunked as jax_ssd_chunked

    want = jax.grad(lambda *a: jnp.sum(jax_ssd_chunked(*a, chunk=128)[0] ** 2),
                    argnums=tuple(range(6)))(
        *map(jnp.asarray, (x, dt, A, Bm, Cm, D)))
    assert not np.isfinite(_np(want[2])).all()    # the reference's fault
    ins = [_t(a).requires_grad_(True) for a in (x, dt, A, Bm, Cm, D)]
    y, _ = ssd_chunked(*ins, chunk=128)
    got = torch.autograd.grad(torch.sum(y ** 2), ins)
    for w, g in zip(want, got):
        g = g.numpy()
        assert np.isfinite(g).all()
        w = _np(w)
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=1e-4,
                                   atol=1e-4 * np.abs(w[fin]).max())


# ---------------------------------------------------------------------------
# one train step of the model
# ---------------------------------------------------------------------------
class _Capture:
    """An optimizer that keeps the gradients it is handed."""

    def update(self, grads, state, params):
        self.grads = grads
        return params, state


STEP_CASES = [
    ("qwen1p5_0p5b", False, "bfloat16"),
    ("qwen1p5_0p5b", True, "bfloat16"),
    ("mamba2_780m", False, "bfloat16"),
    ("qwen1p5_0p5b", True, "float32"),
    ("mamba2_780m", False, "float32"),
]


def _batch(seed=1, B=2, S=64):
    toks = np.random.default_rng(seed).integers(3, 512, (B, S)).astype(np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, 1)}


@pytest.mark.parametrize("arch,flash,act", STEP_CASES,
                         ids=[f"{a}-flash{int(f)}-{d}" for a, f, d in STEP_CASES])
def test_train_step_matches_jax(arch, flash, act):
    jm = jax_build_model(jax_get_reduced(arch).with_(use_flash_kernel=flash))
    jparams = jm.init(jax.random.PRNGKey(0))
    batch = _batch()
    pm = build_model(get_reduced(arch).with_(use_flash_kernel=flash))
    pparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    jembed, pembed = jm.embed_tokens, pm.embed_tokens
    with mock.patch.object(jm, "embed_tokens", lambda p, t: jembed(
            p, t, dtype=getattr(jnp, act))), \
            mock.patch.object(pm, "embed_tokens", lambda p, t: pembed(
                p, t, dtype=getattr(torch, act))):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        logits, _ = jax.jit(jm.apply)(jparams, jb)
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p, b: JST.compute_loss(jm, p, b)[0]))(jparams, jb)
        pb = {k: _t(v) for k, v in batch.items()}
        with torch.no_grad():
            plogits, aux = pm.apply(pparams, pb)
        cap = _Capture()
        state = {"params": pparams, "opt": {},
                 "step": torch.zeros((), dtype=torch.int32)}
        new_state, metrics = PST.make_train_step(pm, cap)(state, pb)
    assert float(aux["router_lb"]) == 0.0 and int(new_state["step"]) == 1
    assert set(metrics) == {"ce", "router_lb", "loss"}
    grad_tol = STEP_GRAD_TOL if act == "bfloat16" else STEP_F32_TOL
    logit_tol = 3e-2 if act == "bfloat16" else 1e-4
    np.testing.assert_allclose(plogits.float().numpy(), _np(logits),
                               atol=logit_tol, rtol=0)
    loss_tol = STEP_LOSS_TOL if act == "bfloat16" else 1e-6
    assert abs(float(metrics["loss"]) - float(jloss)) <= loss_tol * float(jloss)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jgrads),
                            tree_leaves(cap.grads)):
        a = _np(a)
        scale = float(np.abs(a).max())
        assert scale > 0, jax.tree_util.keystr(path)
        err = float(np.abs(b.float().numpy() - a).max())
        assert err <= grad_tol * scale, (jax.tree_util.keystr(path), err / scale)


def _port_grads(model, params, batch):
    cap = _Capture()
    state = {"params": params, "opt": {},
             "step": torch.zeros((), dtype=torch.int32)}
    _, metrics = PST.make_train_step(model, cap)(state, batch)
    return metrics, cap.grads


@pytest.mark.parametrize("arch", ["qwen1p5_0p5b", "mamba2_780m"])
def test_remat_policies_give_equal_grads(arch):
    """none, full and selective compute the same ops on the same inputs:
    the recompute repeats the forward bit for bit, so the gradients are
    equal (``torch.equal``)."""
    base = get_reduced(arch).with_(use_flash_kernel=arch.startswith("qwen"))
    params = build_model(base).init(torch.Generator().manual_seed(0))
    batch = {k: _t(v) for k, v in _batch(S=64).items()}
    out = {}
    for remat in ("none", "full", "selective"):
        out[remat] = _port_grads(build_model(base.with_(remat=remat)), params,
                                 batch)
    for remat in ("full", "selective"):
        assert torch.equal(out[remat][0]["loss"], out["none"][0]["loss"])
        for a, b in zip(tree_leaves(out["none"][1]),
                        tree_leaves(out[remat][1])):
            assert torch.equal(a, b), remat


def test_scan_block_size_groups_give_equal_grads():
    """Layers folded two to a remat group: the same gradients as one."""
    base = get_reduced("qwen1p5_0p5b")
    params = build_model(base).init(torch.Generator().manual_seed(0))
    batch = {k: _t(v) for k, v in _batch(S=32).items()}
    one = _port_grads(build_model(base), params, batch)[1]
    two = _port_grads(build_model(base.with_(scan_block_size=2)), params,
                      batch)[1]
    for a, b in zip(tree_leaves(one), tree_leaves(two)):
        assert torch.equal(a, b)


def test_grad_accum_matches_one_batch():
    """grad_accum=2 over contiguous halves against the whole batch: the mean
    of two half-batch means is the batch mean (equal halves), so only f32
    summation order differs (1e-5 of each leaf's largest gradient), with
    f32 activations; and the metrics are averaged."""
    cfg = get_reduced("qwen1p5_0p5b")
    model = build_model(cfg)
    embed = model.embed_tokens
    model.embed_tokens = lambda p, t: embed(p, t, dtype=torch.float32)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {k: _t(v) for k, v in _batch(B=4, S=32).items()}
    grads = {}
    for n in (1, 2):
        cap = _Capture()
        step = PST.make_train_step(model, cap, grad_accum=n)
        _, m = step({"params": params, "opt": {},
                     "step": torch.zeros((), dtype=torch.int32)}, batch)
        grads[n] = (m, cap.grads)
    assert abs(float(grads[1][0]["loss"]) - float(grads[2][0]["loss"])) < 1e-5
    for a, b in zip(tree_leaves(grads[1][1]), tree_leaves(grads[2][1])):
        assert b.dtype == torch.float32
        scale = float(a.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * scale


def test_grad_accum_carry_is_f32_under_bf16_params():
    """bf16 params give bf16 gradients; the accumulated carry is f32, so the
    averaged gradient equals the f32 mean of the micro-gradients exactly."""
    cfg = get_reduced("qwen1p5_0p5b")
    model = build_model(cfg)
    params = tree_map(lambda p: p.bfloat16(),
                      model.init(torch.Generator().manual_seed(0)))
    batch = {k: _t(v) for k, v in _batch(B=4, S=32).items()}
    cap = _Capture()
    PST.make_train_step(model, cap, grad_accum=2)(
        {"params": params, "opt": {},
         "step": torch.zeros((), dtype=torch.int32)}, batch)
    micro = [_port_grads(model, params, mb)[1]
             for mb in PST.microbatch(batch, 2)]
    for g, a, b in zip(tree_leaves(cap.grads), tree_leaves(micro[0]),
                       tree_leaves(micro[1])):
        assert a.dtype == torch.bfloat16 and g.dtype == torch.float32
        assert torch.equal(g, (a.float() + b.float()) / 2)
