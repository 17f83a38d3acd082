"""The port's dense archs beyond Qwen against the JAX package, on the CPU,
and the flash wrapper at head dim 160.

Reduced ``stablelm_1p6b``, ``llama3_8b`` (``rope_theta`` 500000),
``granite_34b`` (MQA: one kv head) and ``stablelm_12b`` (4 query heads
over 2 kv heads; ``reduce_config`` sets dh 64), and ``stablelm_12b`` at its
own head dim 160 with ``use_flash_kernel`` on both sides: JAX's Pallas
flash kernel in interpret mode, the port's wrapper through its plain
version (the tensors lie on the CPU).  JAX's params are carried across by
``repro_torch.bridge``; inputs are numpy draws from a seed.

Tolerances, stated per assertion:

- bf16 activations (the served model): ``LOGIT_TOL`` 3e-2 on logits and
  ``CACHE_TOL`` 6e-2 of the largest element on the bf16 K/V caches, the
  bounds of ``tests/test_torch_serve.py`` and ``tests/test_torch_engine.py``
  (XLA and eager PyTorch round bf16 at other places; logits here are of
  size ~1-2, where a bf16 step is 2**-7..2**-6).
- f32 activations and caches: 5e-4 on logits, JAX's own decode-vs-forward
  contract (``tests/test_decode_consistency.py``), here between the
  packages.
- the windowed variant (window 8 at 20 tokens, through the ring buffer):
  the same bounds; its dense engine's greedy streams equal JAX's engine's
  or part where JAX's own top-2 margin is within ``LOGIT_TOL`` (a bf16
  argmax tie, as ``tests/test_torch_serve.py`` holds Qwen's).
- ``flash_attention`` at dh 160 against JAX's kernel: 1e-5 in f32 and
  2.5e-2 in bf16, the JAX kernel test's bounds, and 2e-4 on the gradients,
  as ``tests/test_torch_flash_dh80.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from unittest import mock

from repro.configs import get_reduced as jax_get_reduced
from repro.kernels.flash.ops import flash_attention as jax_flash_attention
from repro.models import build_model as jax_build_model
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.workload import static_trace as jax_static_trace
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels.flash import ops
from repro_torch.models import build_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.workload import static_trace

LOGIT_TOL = 3e-2
CACHE_TOL = 6e-2
F32_TOL = 5e-4
GRAD_TOL = 2e-4
P, G = 24, 3          # prompt length, teacher-forced decode steps
# arch, overrides of the reduced config (on both sides)
CASES = {
    "stablelm_1p6b": ("stablelm_1p6b", {}),
    "llama3_8b": ("llama3_8b", {}),
    "granite_34b": ("granite_34b", {}),
    "stablelm_12b": ("stablelm_12b", {}),
    "stablelm_12b_dh160": ("stablelm_12b", {"head_dim": 160,
                                            "use_flash_kernel": True}),
}


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


def _close(got, want, rel, what=""):
    """|got - want| <= rel * max|want|, elementwise."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=what)


def _cfgs(key, **extra):
    arch, kw = CASES[key]
    kw = {**kw, **extra}
    return jax_get_reduced(arch).with_(**kw), get_reduced(arch).with_(**kw)


def _acts(model, dtype):
    """``model`` with its activations (``embed_tokens``) in ``dtype``."""
    embed = model.embed_tokens
    return mock.patch.object(model, "embed_tokens",
                             lambda p, t, dtype_=None: embed(p, t, dtype=dtype))


def _run_jax(cfg, params, prompt, f32=False):
    """JAX's apply logits, prefill logits and cache, G teacher-forced greedy
    decode steps (their logits and the cache after each)."""
    model = jax_build_model(cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    dt = jnp.float32 if f32 else jnp.bfloat16
    S = prompt.shape[1]
    max_len = S + G
    with _acts(model, dt):
        full, _ = jax.jit(model.apply)(jp, {"tokens": jnp.asarray(prompt)})
        logits, cache = jax.jit(lambda p, t: model.prefill(
            p, {"tokens": t}, max_len=max_len, cache_dtype=dt))(
                jp, jnp.asarray(prompt))
        out = {"apply": _np(full), "prefill_logits": _np(logits),
               "caches": [jax.tree_util.tree_map(_np, cache)]}
        step = jax.jit(model.decode_step)
        tokens, step_logits = [], []
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        for i in range(G):
            tokens.append(np.asarray(tok))
            logits, cache = step(jp, cache, tok,
                                 jnp.full((prompt.shape[0],), S + i, jnp.int32))
            step_logits.append(_np(logits))
            out["caches"].append(jax.tree_util.tree_map(_np, cache))
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    out.update(tokens=tokens, step_logits=step_logits)
    return out


def _run_port(cfg, params, prompt, tokens, f32=False):
    model = build_model(cfg)
    pp = params_from_jax(params)
    dt = torch.float32 if f32 else torch.bfloat16
    tok = torch.as_tensor(prompt, dtype=torch.int64)
    S = prompt.shape[1]
    with _acts(model, dt), torch.no_grad():
        full, _ = model.apply(pp, {"tokens": tok})
        logits, cache = model.prefill(pp, {"tokens": tok}, max_len=S + G,
                                      cache_dtype=dt)
        out = {"apply": _np(full.float()),
               "prefill_logits": _np(logits.float()),
               "caches": [params_to_numpy(cache)]}
        step_logits = []
        for i, t in enumerate(tokens):
            logits, cache = model.decode_step(
                pp, cache, torch.as_tensor(np.array(t), dtype=torch.int32),
                torch.full((prompt.shape[0],), S + i))
            step_logits.append(_np(logits.float()))
            out["caches"].append(params_to_numpy(cache))
    out["step_logits"] = step_logits
    return out


def _both(jcfg, pcfg, f32=False, seed=0, prompt_len=P):
    params = jax.tree_util.tree_map(
        np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(seed)))
    prompt = np.random.default_rng(seed + 1).integers(
        3, jcfg.vocab, size=(2, prompt_len), dtype=np.int32)
    ref = _run_jax(jcfg, params, prompt, f32)
    return ref, _run_port(pcfg, params, prompt, ref["tokens"], f32)


@pytest.fixture(scope="module")
def runs():
    return {key: _both(*_cfgs(key)) for key in CASES}


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["stablelm_1p6b", "stablelm_12b",
                                  "llama3_8b", "granite_34b"])
def test_full_width_config_builds_as_jax(arch):
    """The published config builds; its param tree and shapes are JAX's
    (on ``meta``, no memory), and the dense arch serves from pages."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.device import MetaGenerator

    cfg = get_config(arch)
    model = build_model(cfg)
    assert model.kinds == ["dense_block"] * cfg.n_layers
    assert model.supports_paged_cache()
    shapes = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: tuple(a.shape), t)
    want = shapes(jax.eval_shape(jax_build_model(jax_get_config(arch)).init,
                                 jax.random.PRNGKey(0)))
    assert shapes(model.init(MetaGenerator())) == want


# ---------------------------------------------------------------------------
# the forward, prefill and decode against JAX (bf16)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("key", list(CASES))
def test_apply_prefill_and_decode_logits_match_jax(runs, key):
    ref, port = runs[key]
    assert port["apply"].shape == ref["apply"].shape
    np.testing.assert_allclose(port["apply"], ref["apply"], atol=LOGIT_TOL,
                               rtol=0)
    np.testing.assert_allclose(port["prefill_logits"], ref["prefill_logits"],
                               atol=LOGIT_TOL, rtol=0)
    for a, b in zip(port["step_logits"], ref["step_logits"]):
        np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("key", list(CASES))
def test_caches_match_jax(runs, key):
    """The prefill's K/V cache and the cache after each decode step, within
    ``CACHE_TOL`` of each leaf's largest element."""
    ref, port = runs[key]
    for step, (got, want) in enumerate(zip(port["caches"], ref["caches"])):
        for k in want["blocks"]:
            assert got["blocks"][k].shape == want["blocks"][k].shape
            _close(got["blocks"][k], want["blocks"][k], CACHE_TOL,
                   f"step {step} {k}")


def test_dh160_cache_holds_the_wide_heads(runs):
    _, port = runs["stablelm_12b_dh160"]
    assert port["caches"][0]["blocks"]["k"].shape == (2, 2, P + G, 2, 160)


@pytest.mark.parametrize("key", ["llama3_8b", "granite_34b",
                                 "stablelm_12b_dh160"])
def test_f32_logits_match_jax(key):
    """f32 activations and caches: the forward, the prefill and each decode
    step within 5e-4."""
    ref, port = _both(*_cfgs(key), f32=True, seed=3)
    for name in ("apply", "prefill_logits"):
        np.testing.assert_allclose(port[name], ref[name], atol=F32_TOL, rtol=0)
    for a, b in zip(port["step_logits"], ref["step_logits"]):
        np.testing.assert_allclose(a, b, atol=F32_TOL, rtol=0)


# ---------------------------------------------------------------------------
# a sliding window through the ring buffer
# ---------------------------------------------------------------------------
W, S_W = 8, 20


def _windowed():
    return _cfgs("stablelm_1p6b", window=W)


def test_windowed_forward_and_ring_cache_match_jax():
    """Window 8 at 20 prompt tokens: the forward, the prefill's ring-packed
    cache of 8 slots (``_pad_cache_seq``) and, after each decode step, the
    ring as ``gqa_decode`` rewrote it, against JAX's."""
    jcfg, pcfg = _windowed()
    ref, port = _both(jcfg, pcfg, seed=5, prompt_len=S_W)
    np.testing.assert_allclose(port["apply"], ref["apply"], atol=LOGIT_TOL,
                               rtol=0)
    np.testing.assert_allclose(port["prefill_logits"], ref["prefill_logits"],
                               atol=LOGIT_TOL, rtol=0)
    for a, b in zip(port["step_logits"], ref["step_logits"]):
        np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=0)
    for step, (got, want) in enumerate(zip(port["caches"], ref["caches"])):
        assert got["blocks"]["k"].shape == (2, 2, W, 2, 64)
        for k in want["blocks"]:
            _close(got["blocks"][k], want["blocks"][k], CACHE_TOL,
                   f"step {step} {k}")


def test_windowed_forward_masks_beyond_the_window():
    """A token more than ``window`` positions back changes no logit of the
    last position (the window mask in the forward), and the windowed arch
    refuses pages, as in JAX."""
    _, pcfg = _windowed()
    model = build_model(pcfg)
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        3, 512, (1, S_W)), dtype=torch.int64)
    other = toks.clone()
    other[0, 0] = (toks[0, 0] + 1) % 512
    with torch.no_grad():
        a, _ = model.apply(params, {"tokens": toks})
        b, _ = model.apply(params, {"tokens": other})
    # layer 2 reaches back 2 * (W - 1) positions through layer 1
    assert torch.equal(a[0, 2 * W - 1:], b[0, 2 * W - 1:])
    assert not torch.equal(a[0, :W], b[0, :W])
    assert not model.supports_paged_cache()


def test_windowed_dense_engine_streams_match_jax_or_tie():
    """Both packages' dense engines (2 slots, greedy) on three 12-token
    prompts, 10 tokens each, so every stream wraps the ring of 8: each
    stream equals JAX's, or parts where JAX's own logits (teacher-forced
    along its stream) have a top-2 margin within ``LOGIT_TOL``."""
    jcfg, pcfg = _windowed()
    params = jax.tree_util.tree_map(
        np.asarray, jax_build_model(jcfg).init(jax.random.PRNGKey(4)))
    prompts = np.random.default_rng(6).integers(3, jcfg.vocab, (3, 12),
                                                dtype=np.int32)
    eng = dict(n_slots=2, max_len=24, greedy=True, block_len=0)
    jm = jax_build_model(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jout = JaxServeEngine(jm, jp, **eng).run(jax_static_trace(prompts, 10),
                                              realtime=False)
    pout = ServeEngine(build_model(pcfg), params_from_jax(params), **eng).run(
        static_trace(prompts, 10), realtime=False)
    assert pout["completed"] == jout["completed"] == 3
    for r, (prow, jrow) in enumerate(zip(pout["requests"], jout["requests"])):
        a, b = prow["gen_ids"], jrow["gen_ids"]
        assert len(a) == len(b) == 10
        if a == b:
            continue
        i = next(j for j in range(10) if a[j] != b[j])
        logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(prompts[r:r + 1])},
                                   max_len=24)
        for j in range(i):
            logits, cache = jm.decode_step(jp, cache, jnp.asarray([b[j]]),
                                           jnp.asarray([12 + j]))
        top2 = np.sort(_np(logits[0]))[-2:]
        assert top2[1] - top2[0] <= LOGIT_TOL, (r, i)


# ---------------------------------------------------------------------------
# flash_attention at dh 160 against JAX's Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------
# B, Sq, Skv, H, K, dh, causal, window, dtype
DH160_CASES = [
    (1, 256, 256, 8, 2, 160, True, 0, jnp.float32),       # StableLM-2-12B GQA
    (1, 256, 256, 8, 2, 160, True, 0, jnp.bfloat16),
    (1, 300, 300, 4, 4, 160, True, 64, jnp.float32),      # window, ragged
    (1, 300, 300, 4, 4, 160, True, 64, jnp.bfloat16),
    (1, 128, 384, 4, 1, 160, False, 0, jnp.bfloat16),     # MQA, Sq != Skv
]
_TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _case_id(c):
    return (f"B{c[0]}S{c[1]}x{c[2]}H{c[3]}K{c[4]}d{c[5]}"
            f"{'c' if c[6] else 'b'}w{c[7]}{c[8].__name__}")


def _qkv(B, Sq, Skv, H, K, dh, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, dh), dtype=np.float32),
            rng.standard_normal((B, Skv, K, dh), dtype=np.float32),
            rng.standard_normal((B, Skv, K, dh), dtype=np.float32))


def test_dh160_is_a_supported_head_dim():
    assert 160 in ops.SUPPORTED_HEAD_DIMS


@pytest.mark.parametrize("case", DH160_CASES, ids=_case_id)
def test_port_flash_matches_jax_kernel_at_dh160(case):
    causal, window, dt = case[6:]
    qn, kn, vn = _qkv(*case[:6])
    want = jax_flash_attention(*(jnp.asarray(a).astype(dt)
                                 for a in (qn, kn, vn)),
                               causal=causal, window=window)
    tdt = _TORCH_DTYPE[dt]
    before = ops.launches
    got = ops.flash_attention(*(torch.from_numpy(a).to(tdt)
                                for a in (qn, kn, vn)),
                              causal=causal, window=window)
    assert ops.launches == before   # CPU tensors: plain version, no launch
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    tol = 2.5e-2 if dt == jnp.bfloat16 else 1e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def test_dh160_gradients_match_jax_custom_vjp():
    """The wrapper's ``autograd.Function`` backward against ``jax.grad`` of
    JAX's ``custom_vjp`` at dh 160, GQA, causal, f32."""
    qn, kn, vn = _qkv(1, 160, 160, 4, 2, 160, seed=3)
    want = jax.grad(lambda q, k, v: jnp.sum(jax_flash_attention(
        q, k, v, causal=True) ** 2), argnums=(0, 1, 2))(
        *map(jnp.asarray, (qn, kn, vn)))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (qn, kn, vn)]
    out = ops.flash_attention(*ins, causal=True)
    got = torch.autograd.grad(torch.sum(out ** 2), ins)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   atol=GRAD_TOL)
