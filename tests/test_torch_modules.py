"""The port's model modules against the JAX package's, one function at a time.

Reduced qwen1.5-0.5b (4 query heads over 2 kv heads, so GQA groups of 2; QKV
bias) with JAX's params carried across by ``repro_torch.bridge`` and inputs
made with numpy from a seed.  Everything runs in f32 and is held to 1e-5:
both packages compute the same f32 expression, and what differs is only the
order in which the matrix products and softmax sums are taken (sums of a few
hundred terms of size ~1, whose f32 rounding stays near 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as JA
import repro.models.common as JC
import repro.models.mlp as JM
import repro.models.transformer as JT
import repro_torch.models.attention as PA
import repro_torch.models.common as PC
import repro_torch.models.mlp as PM
import repro_torch.models.transformer as PT
from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.models import build_model

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH = "qwen1p5_0p5b"


def _cfgs(**kw):
    return jax_get_reduced(ARCH).with_(**kw), get_reduced(ARCH).with_(**kw)


def _np(x):
    return np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def attn_params():
    """One layer's GQA params from JAX's init, with non-zero biases."""
    jcfg, _ = _cfgs()
    p = jax.tree_util.tree_map(np.asarray, JA.init_gqa(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for name in ("bq", "bk", "bv"):
        p[name] = (0.1 * rng.standard_normal(p[name].shape)).astype(np.float32)
    return p


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_apply_norm_matches_jax(norm_type):
    jcfg, pcfg = _cfgs(norm_type=norm_type)
    x = _x((2, 5, jcfg.d_model))
    rng = np.random.default_rng(2)
    p = {"scale": 1 + 0.1 * rng.standard_normal(jcfg.d_model, dtype=np.float32)}
    if norm_type == "layernorm":
        p["bias"] = 0.1 * rng.standard_normal(jcfg.d_model, dtype=np.float32)
    want = JC.apply_norm(jcfg, jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    got = PC.apply_norm(pcfg, params_from_jax(p), _t(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("theta,start", [(10000.0, 0), (500000.0, 37)])
def test_apply_rope_matches_jax(theta, start):
    x = _x((2, 6, 4, 64))
    pos = np.arange(start, start + 6, dtype=np.int32)
    want = JC.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = PC.apply_rope(_t(x), _t(pos), theta)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_apply_rope_per_slot_positions_match_jax():
    """The decode shape: one token per slot, each at its own position."""
    x = _x((3, 1, 4, 64))
    pos = np.array([[0], [5], [1023]], dtype=np.int32)
    want = JC.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = PC.apply_rope(_t(x), _t(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_forward_matches_jax(act):
    jcfg, pcfg = _cfgs(act=act)
    p = jax.tree_util.tree_map(np.asarray, JM.init_mlp(jcfg, jax.random.PRNGKey(3)))
    x = _x((2, 5, jcfg.d_model))
    want = JM.mlp_forward(jcfg, jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    got = PM.mlp_forward(pcfg, params_from_jax(p), _t(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("branch", ["flash", "full", "blockwise"])
def test_gqa_forward_matches_jax(branch, window, attn_params, monkeypatch):
    """Every branch of ``gqa_forward``: the flash kernel (Pallas interpret vs
    the port's plain version on the CPU), the plain einsum path, and the
    blockwise path, reached by lowering both packages' S threshold."""
    jcfg, pcfg = _cfgs(use_flash_kernel=branch == "flash", window=window)
    if branch == "blockwise":
        monkeypatch.setattr(JA, "_BLOCKWISE_AT", 8)
        monkeypatch.setattr(PA, "_BLOCKWISE_AT", 8)
    S = 24
    x = _x((2, S, jcfg.d_model))
    pos = np.arange(S, dtype=np.int32)
    jp = jax.tree_util.tree_map(jnp.asarray, attn_params)
    want, (wk, wv) = JA.gqa_forward(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                                    return_kv=True)
    got, (gk, gv) = PA.gqa_forward(pcfg, params_from_jax(attn_params), _t(x),
                                   _t(pos), return_kv=True)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    np.testing.assert_allclose(gk.numpy(), _np(wk), **TOL)
    np.testing.assert_allclose(gv.numpy(), _np(wv), **TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_blockwise_attn_ragged_kv_blocks_match_jax(causal, window):
    """Several kv blocks of 8 over T = 27 (a ragged last block): the port
    slices it short, JAX pads it with keys that get probability 0."""
    q, k, v = _x((2, 27, 4, 64), 4), _x((2, 27, 2, 64), 5), _x((2, 27, 2, 64), 6)
    pos = np.arange(27, dtype=np.int32)
    want = JA._blockwise_attn(*(jnp.asarray(a) for a in (q, k, v)),
                              jnp.asarray(pos), jnp.asarray(pos), window, causal,
                              kv_block=8)
    got = PA._blockwise_attn(_t(q), _t(k), _t(v), _t(pos), _t(pos), window,
                             causal, kv_block=8)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("window", [0, 6])
def test_gqa_decode_matches_jax(window, attn_params):
    """Three decode steps over two slots at different positions, from a
    random cache; with ``window`` 6 < positions the ring buffer wraps."""
    jcfg, pcfg = _cfgs(window=window)
    max_len = 16
    jcache = JA.gqa_init_cache(jcfg, 2, max_len, jnp.float32)
    L = jcache["k"].shape[1]
    assert L == (6 if window else max_len)
    rng = np.random.default_rng(7)
    cache = {n: rng.standard_normal((2, L, 2, 64), dtype=np.float32)
             for n in ("k", "v")}
    jcache = {n: jnp.asarray(a) for n, a in cache.items()}
    pcache = PA.gqa_init_cache(pcfg, 2, max_len, torch.float32)
    for n in ("k", "v"):
        pcache[n].copy_(_t(cache[n]))
    jp = jax.tree_util.tree_map(jnp.asarray, attn_params)
    pp = params_from_jax(attn_params)
    pos = np.array([3, 9], dtype=np.int32)
    for step in range(3):
        x = _x((2, 1, jcfg.d_model), 10 + step)
        want, jcache = JA.gqa_decode(jcfg, jp, jcache, jnp.asarray(x),
                                     jnp.asarray(pos + step))
        got, same = PA.gqa_decode(pcfg, pp, pcache, _t(x), _t(pos + step))
        assert same is pcache               # updated in place
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
        for n in ("k", "v"):
            np.testing.assert_allclose(pcache[n].numpy(), _np(jcache[n]), **TOL)


@pytest.mark.parametrize("S,max_len,window", [(5, 9, 0), (9, 9, 0), (4, 12, 6),
                                              (11, 12, 6)])
def test_pad_cache_seq_matches_jax(S, max_len, window):
    k = _x((1, S, 2, 3))
    want = JT._pad_cache_seq(jnp.asarray(k), max_len, window)
    got = PT._pad_cache_seq(_t(k), max_len, window)
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_insert_cache_overwrites_the_whole_slot_row_as_jax():
    jcfg, pcfg = _cfgs()
    jm, pm = jax_build_model(jcfg), build_model(pcfg)
    rng = np.random.default_rng(8)
    pool = {n: rng.standard_normal((2, 3, 10, 2, 64), dtype=np.float32)
            for n in ("k", "v")}
    req = {n: rng.standard_normal((2, 1, 10, 2, 64), dtype=np.float32)
           for n in ("k", "v")}
    want = jm.insert_cache({"blocks": {n: jnp.asarray(a) for n, a in pool.items()}},
                           {"blocks": {n: jnp.asarray(a) for n, a in req.items()}}, 1)
    pcache = {"blocks": params_from_jax(pool)}
    got = pm.insert_cache(pcache, {"blocks": params_from_jax(req)}, 1)
    assert got is pcache
    for n in ("k", "v"):
        np.testing.assert_array_equal(got["blocks"][n].numpy(),
                                      _np(want["blocks"][n]))


def test_init_distributions_match_jax():
    """Seeded torch init cannot give JAX's numbers; it gives its law:
    truncated normal at ±3σ scaled by 1/sqrt(fan_in), and normal × 0.02."""
    gen = torch.Generator().manual_seed(0)
    w = PC.dense_init(gen, (256, 4, 64), 256).numpy()
    jw = _np(JC.dense_init(jax.random.PRNGKey(0), (256, 4, 64), 256))
    assert np.abs(w).max() <= 3 / 16 + 1e-7
    np.testing.assert_allclose(w.std(), jw.std(), rtol=0.02)
    e = PC.embed_init(gen, (512, 256)).numpy()
    je = _np(JC.embed_init(jax.random.PRNGKey(1), (512, 256)))
    np.testing.assert_allclose(e.std(), je.std(), rtol=0.02)
    np.testing.assert_allclose(e.std(), 0.02, rtol=0.02)


def test_model_init_tree_matches_jax():
    """The port's init makes the JAX tree: the same keys and shapes, so the
    bridge carries params either way."""
    jcfg, pcfg = _cfgs()
    jshapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape),
        jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0)))
    params = build_model(pcfg).init(torch.Generator().manual_seed(0))
    pshapes = jax.tree_util.tree_map(lambda t: tuple(t.shape), params)
    assert pshapes == jshapes
