"""The port's MLA attention and MTP head (DeepSeek-V3) against the JAX
package, on the CPU.

Reduced ``deepseek_v3_671b``: 2 layers, the first dense and the second MoE
(4 routed experts of width 128, top 2, 1 shared), 4 heads with a query
latent of 96, a KV latent of 64, nope 32 + rope 16 and v 32, and the MTP
head, with JAX's params carried across by ``repro_torch.bridge``.  Inputs
are numpy draws from a seed.

Tolerances, stated per assertion:

- each MLA function in f32 against JAX's on the same inputs and params:
  ``FN_TOL`` 2e-5 of the output's largest element, the written latent
  rows of the caches too (the same f32 products summed in other orders;
  6.2e-7 is the largest seen here), and the rows neither wrote ``==``;
- the model's decode contracts, JAX's own bounds
  (``tests/test_decode_consistency.py``): decode vs forward 5e-4, prefill
  vs decode-prefix 5e-3, f32; absorb vs the expanded decode, and the paged
  decode vs the dense one, ``DECODE_TOL`` 5e-4 in f32, the bound of decode
  vs forward: both are another order of the same f32 sums (absorb folds
  ``wkv_b`` into the query and output sides; 1.7e-6 seen here, decode vs
  forward 1.4e-6);
- logits, the router balance loss and the MTP loss against JAX's: 5e-4
  (logits) and 1e-6 (losses, of the loss where it is above 1: logsumexp
  and a gather of the same f32 logits summed in other orders) in f32; in
  bf16 ``LOGIT_TOL`` 3e-2 on logits at every token whose routing agrees
  (``_flips``, as ``tests/test_torch_moe.py``), and ``STEP_LOSS_TOL``
  3e-3 of each loss;
- one train step: ``tests/test_torch_moe.py``'s bounds (3e-3 of the loss
  and 5e-2 of each leaf's largest gradient in bf16, where 3.5e-2 at the
  MTP block's ``wq_b`` is the largest seen here; 1e-6 and 1e-4 in f32);
- the quickstart curve: ``tests/test_torch_gym.py``'s ``CURVE_TOL`` 2e-3.
"""
import contextlib
import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from unittest import mock

import repro.ckpt as JCK
import repro.models.attention as JA
import repro.models.moe as JMOE
import repro_torch.models.attention as PA
import repro_torch.models.moe as PMOE
from repro.config.resolver import resolve_config as jax_resolve_config
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.core.components import register_all as jax_register_all
from repro.models import build_model as jax_build_model
from repro.optim.adamw import AdamW as JaxAdamW
from repro.posttrain import lora as JLO
from repro.telemetry import accounting as JACC
from repro.train import steps as JST
from repro_torch.bridge import params_from_jax
from repro_torch.ckpt import AsyncCheckpointer, read_manifest, restore
from repro_torch.config.resolver import load_yaml, resolve_config
from repro_torch.configs import SHAPES, get_config, get_reduced
from repro_torch.core.components import register_all
from repro_torch.device import MetaGenerator
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.posttrain import lora as LO
from repro_torch.run.cli import main as cli_main
from repro_torch.run.overrides import apply_overrides, parse_overrides
from repro_torch.telemetry import accounting as ACC
from repro_torch.train import steps as PST

ARCH = "deepseek_v3_671b"
ROOT = os.path.join(os.path.dirname(__file__), "..")
QUICKSTART = os.path.join(ROOT, "examples", "configs", "quickstart.yaml")
SERVE_YAML = os.path.join(ROOT, "examples", "configs", "serve.yaml")
FN_TOL = 2e-5
F32_TOL = 5e-4
DECODE_TOL = 5e-4
PREFILL_DECODE_TOL = 5e-3
LOGIT_TOL = 3e-2
STEP_LOSS_TOL = 3e-3
STEP_GRAD_TOL = 5e-2
STEP_F32_TOL = 1e-4
CURVE_TOL = 2e-3


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


def _t(a, dtype=torch.float32):
    """A private copy: the port writes caches in place."""
    return torch.tensor(np.asarray(a)).to(dtype)


@pytest.fixture(scope="module")
def ds():
    """Reduced DeepSeek-V3 in both packages on JAX's params."""
    jcfg = jax_get_reduced(ARCH)
    jm = jax_build_model(jcfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    jax.jit(jm.init)(jax.random.PRNGKey(0)))
    return {"jcfg": jcfg, "cfg": get_reduced(ARCH), "jm": jm,
            "params": params,
            "jp": jax.tree_util.tree_map(jnp.asarray, params),
            "model": build_model(get_reduced(ARCH)),
            "pp": params_from_jax(params)}


def _attn_layer(ds):
    """Layer 0's MLA params (the dense block) in both packages."""
    p = jax.tree_util.tree_map(lambda a: a[0], ds["params"]["dense_blocks"]
                               ["attn"])
    return jax.tree_util.tree_map(jnp.asarray, p), params_from_jax(p)


def _jit(fn, **static):
    """JAX's ``fn(cfg, ...)`` compiled once, the config (a frozen
    dataclass) and ``static`` keyword arguments fixed."""
    return lambda cfg, *args: jax.jit(
        lambda *a: fn(cfg, *a, **static))(*args)


def _acts(model, dtype):
    embed = model.embed_tokens
    return mock.patch.object(model, "embed_tokens",
                             lambda p, t: embed(p, t, dtype=dtype))


def _close(got, want, tol, what=""):
    want = _np(want)
    err = float(np.abs(_np(got) - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), (what, err)


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------
def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


@pytest.mark.parametrize("depth,n_params", [(3, 2880780288),
                                            (4, 14388066304)])
def test_full_width_tree_and_counts_equal_jax(depth, n_params):
    """Full width at depth 3 (the three dense layers and MTP: the trained
    cell) and 4 (one MoE layer of 256 experts: the served cell): the param
    tree and shapes on ``meta`` are JAX's ``eval_shape``, in JAX's key
    order, and 6·N·D with the inactive routed experts discounted is
    JAX's."""
    cfg = get_config(ARCH).with_(n_layers=depth)
    jcfg = jax_get_config(ARCH).with_(n_layers=depth)
    model = build_model(cfg)
    mine = model.init(MetaGenerator())
    want = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0))
    assert _shapes(mine) == jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                                   want)
    assert list(mine) == ["embed", "final_norm", "lm_head", "dense_blocks",
                          "moe_blocks", "mtp"]
    assert list(mine["mtp"]) == ["proj", "block", "norm"]
    assert _shapes(mine["dense_blocks"]["attn"]) == {
        "wq_a": (3, 7168, 1536), "q_norm": (3, 1536),
        "wq_b": (3, 1536, 128, 192), "wkv_a": (3, 7168, 576),
        "kv_norm": (3, 512), "wkv_b": (3, 512, 128, 256),
        "wo": (3, 128, 128, 7168)}
    assert _shapes(mine["moe_blocks"]["moe"]["w_gate"]) == (
        depth - 3, 256, 7168, 2048)
    for shape in SHAPES:
        got = ACC.model_flops(cfg, SHAPES[shape])
        assert got == JACC.model_flops(jcfg, JAX_SHAPES[shape])
    _, n, n_active = ACC.model_flops(cfg, SHAPES["train_4k"])
    assert n == n_params
    routed = 3 * 7168 * 2048 * 256 * (depth - 3)
    assert n_active == n - routed * (256 - 8) // 256


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_param_axes_match_jax(full):
    cfg = get_config(ARCH) if full else get_reduced(ARCH)
    jcfg = jax_get_config(ARCH) if full else jax_get_reduced(ARCH)
    got = build_model(cfg).param_axes()
    assert got == jax.tree_util.tree_map(
        tuple, jax_build_model(jcfg).param_axes(),
        is_leaf=lambda t: isinstance(t, tuple))
    assert got["mtp"]["proj"] == ("d_model", "d_model")


def test_caches_have_jax_shapes(ds):
    """The dense latent cache as JAX's; the paged pool one scratch block
    longer (``attention.py``)."""
    jm, model = ds["jm"], ds["model"]
    dense = model.init_cache(2, 12, dtype=torch.float32)
    assert _shapes(dense) == jax.tree_util.tree_map(
        lambda a: tuple(a.shape), jm.init_cache(2, 12, dtype=jnp.float32))
    assert _shapes(dense["dense_blocks"]) == {"c_kv": (1, 2, 12, 64),
                                              "k_rope": (1, 2, 12, 16)}
    paged = model.init_paged_cache(5, 4)
    want = jm.init_paged_cache(5, 4)
    for stack in ("dense_blocks", "moe_blocks"):
        for leaf in ("c_kv", "k_rope"):
            s = tuple(want[stack][leaf].shape)
            assert tuple(paged[stack][leaf].shape) == (s[0], s[1] + 1) + s[2:]
            assert paged[stack][leaf].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the MLA functions against JAX's, f32
# ---------------------------------------------------------------------------
def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_mla_qkv_matches_jax(ds):
    jp, pp = _attn_layer(ds)
    x = _x((2, 10, 256), 1)
    pos = np.arange(3, 13)
    want = _jit(JA._mla_qkv)(ds["jcfg"], jp, jnp.asarray(x), jnp.asarray(pos))
    got = PA._mla_qkv(ds["cfg"], pp, _t(x), torch.as_tensor(pos))
    assert [tuple(g.shape) for g in got] == [(2, 10, 4, 32), (2, 10, 4, 16),
                                            (2, 10, 64), (2, 10, 16)]
    for g, w, name in zip(got, want, ("q_nope", "q_rope", "c_kv", "k_rope")):
        _close(g, w, FN_TOL, name)


@pytest.mark.parametrize("path", ["full", "blockwise"])
def test_mla_forward_matches_jax(ds, path, monkeypatch):
    """The full path, and with both packages' ``_BLOCKWISE_AT`` set below S
    the blockwise one (one ragged block of 40 rows of 512); outputs and the
    latent the prefill caches."""
    if path == "blockwise":
        monkeypatch.setattr(JA, "_BLOCKWISE_AT", 16)
        monkeypatch.setattr(PA, "_BLOCKWISE_AT", 16)
    jp, pp = _attn_layer(ds)
    x = _x((2, 40, 256), 2)
    pos = np.arange(40)
    jout, (jc, jr) = _jit(JA.mla_forward, return_latent=True)(
        ds["jcfg"], jp, jnp.asarray(x), jnp.asarray(pos))
    with mock.patch.object(PA, "_mla_blockwise",
                           wraps=PA._mla_blockwise) as blk:
        out, (c, r) = PA.mla_forward(ds["cfg"], pp, _t(x),
                                     torch.as_tensor(pos), return_latent=True)
    assert blk.called == (path == "blockwise")
    assert out.shape == (2, 40, 256)
    _close(out, jout, FN_TOL, "out")
    _close(c, jc, FN_TOL, "c_kv")
    _close(r, jr, FN_TOL, "k_rope")


def test_mla_blockwise_ragged_blocks_match_jax(ds):
    """``_mla_blockwise`` itself at blocks of 16 over 40 rows (the last
    ragged: JAX pads it with masked rows, the port slices it short)."""
    jcfg, cfg = ds["jcfg"], ds["cfg"]
    jp, pp = _attn_layer(ds)
    x = _x((2, 40, 256), 3)
    pos = np.arange(40)
    jq = _jit(JA._mla_qkv)(jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    q = PA._mla_qkv(cfg, pp, _t(x), torch.as_tensor(pos))
    scale = 1 / np.sqrt(48)
    want = _jit(JA._mla_blockwise, scale=scale, kv_block=16)(
        jcfg, jp, *jq, jnp.asarray(pos))
    got = PA._mla_blockwise(cfg, pp, *q, torch.as_tensor(pos), scale,
                            kv_block=16)
    assert got.shape == (2, 40, 4, 32)
    _close(got, want, FN_TOL)


def test_mla_scale_is_that_of_the_mla_dims(ds):
    """The score scale is 1/sqrt(nope + rope) in both packages, whatever
    ``head_dim`` says: at head_dim 64 (not the reduced config's 48) the
    forward is unchanged."""
    jp, pp = _attn_layer(ds)
    x = _x((1, 12, 256), 4)
    pos = np.arange(12)
    cfg = ds["cfg"].with_(head_dim=64)
    want = _jit(JA.mla_forward)(ds["jcfg"].with_(head_dim=64), jp,
                                jnp.asarray(x), jnp.asarray(pos))
    got = PA.mla_forward(cfg, pp, _t(x), torch.as_tensor(pos))
    same = PA.mla_forward(ds["cfg"], pp, _t(x), torch.as_tensor(pos))
    assert torch.equal(got, same)
    _close(got, want, FN_TOL)


def _dense_cache(B, L, seed):
    rng = np.random.default_rng(seed)
    return {"c_kv": rng.standard_normal((B, L, 64)).astype(np.float32),
            "k_rope": rng.standard_normal((B, L, 16)).astype(np.float32)}


@pytest.mark.parametrize("absorb", [False, True], ids=["expanded", "absorb"])
def test_mla_decode_matches_jax(ds, absorb):
    """One token for 3 slots at their own positions against a filled f32
    latent cache: the output and the cache written in place (``==`` the
    JAX cache's rows, which both packages wrote from the same f32
    latents)."""
    jp, pp = _attn_layer(ds)
    cache = _dense_cache(3, 16, 5)
    x = _x((3, 1, 256), 6)
    pos = np.array([0, 7, 15])
    jout, jc = _jit(JA.mla_decode, absorb=absorb)(
        ds["jcfg"], jp, jax.tree_util.tree_map(jnp.asarray, cache),
        jnp.asarray(x), jnp.asarray(pos))
    pc = {k: _t(v) for k, v in cache.items()}
    out, pc2 = PA.mla_decode(ds["cfg"], pp, pc, _t(x), torch.as_tensor(pos),
                             absorb=absorb)
    assert pc2 is pc
    _close(out, jout, FN_TOL, "out")
    for k in cache:
        _close(pc[k], jc[k], FN_TOL, k)
        rows = np.ones((3, 16), bool)
        rows[np.arange(3), pos] = False
        assert np.array_equal(pc[k].numpy()[rows], cache[k][rows])


def _pool(nb, bl, seed, extra=0):
    rng = np.random.default_rng(seed)
    return {"c_kv": rng.standard_normal((nb + extra, bl, 64)).astype(
                np.float32),
            "k_rope": rng.standard_normal((nb + extra, bl, 16)).astype(
                np.float32)}


@pytest.mark.parametrize("absorb", [False, True], ids=["expanded", "absorb"])
def test_mla_decode_paged_matches_jax(ds, absorb):
    """Three slots through page tables of 3 pages of 4, the middle slot
    inactive (JAX drops its write; the port's goes to the scratch block):
    outputs and the allocator's pages against JAX's."""
    jp, pp = _attn_layer(ds)
    pool = _pool(9, 4, 7, extra=1)
    x = _x((3, 1, 256), 8)
    pos = np.array([2, 6, 11])
    pages = np.array([[4, 0, 8], [1, 2, 3], [7, 6, 5]], np.int32)
    active = np.array([True, False, True])
    jpool = {k: jnp.asarray(v[:9]) for k, v in pool.items()}
    jout, jc = _jit(JA.mla_decode_paged, absorb=absorb)(
        ds["jcfg"], jp, jpool, jnp.asarray(x), jnp.asarray(pos),
        jnp.asarray(pages), jnp.asarray(active))
    pc = {k: _t(v) for k, v in pool.items()}
    out, _ = PA.mla_decode_paged(ds["cfg"], pp, pc, _t(x),
                                 torch.as_tensor(pos), torch.as_tensor(pages),
                                 torch.as_tensor(active), absorb=absorb)
    _close(out, jout, FN_TOL, "out")
    for k in pool:
        _close(pc[k][:9], jc[k], FN_TOL, k)
        # the inactive slot's write went to the scratch block
        assert not np.array_equal(pc[k][9].numpy(), pool[k][9])
        assert np.array_equal(pc[k][2].numpy(), pool[k][2])


def test_mla_prefill_chunk_matches_jax(ds):
    """A chunk of 8 rows at position 4 with 5 valid (3 padding rows whose
    writes JAX drops and the port sends to the scratch block) into a
    request's 4 pages of 4."""
    jp, pp = _attn_layer(ds)
    pool = _pool(6, 4, 9, extra=1)
    for v in pool.values():
        v[:] = 0.0
    x = _x((1, 8, 256), 10)
    pos = np.arange(4, 12)
    row = np.array([3, 0, 5, 1], np.int32)
    jpool = {k: jnp.asarray(v[:6]) for k, v in pool.items()}
    jout, jc = _jit(JA.mla_prefill_chunk)(
        ds["jcfg"], jp, jpool, jnp.asarray(x), jnp.asarray(pos),
        jnp.asarray(row), jnp.int32(5))
    pc = {k: _t(v) for k, v in pool.items()}
    out, _ = PA.mla_prefill_chunk(ds["cfg"], pp, pc, _t(x),
                                  torch.as_tensor(pos), torch.as_tensor(row),
                                  5)
    _close(out, jout, FN_TOL, "out")
    for k in pool:
        _close(pc[k][:6], jc[k], FN_TOL, k)
        assert pc[k][6].abs().sum() > 0           # the padding rows' writes
        # page 2 (block 5) holds position 8 only: 9-11 are padding
        assert pc[k][5][0].abs().sum() > 0 and not pc[k][5][1:].any()


# ---------------------------------------------------------------------------
# the reduced model
# ---------------------------------------------------------------------------
S, B_ = 20, 2


def _tokens(seed, s=S):
    return np.random.default_rng(seed).integers(3, 512, (B_, s)).astype(
        np.int32)


@contextlib.contextmanager
def _routes():
    """Record each package's routing of the MoE layer (the first call of a
    run): JAX's indices with its router input and weights, through
    ``jax.debug.callback`` inside jit, and the port's indices."""
    rec = {"jax": [], "port": []}
    # the port's layer routes through ``route_stats`` (the balance loss
    # is formed from its sums: ROADMAP C8)
    jroute, proute = JMOE.route, PMOE.route_stats

    def jax_route(cfg, w, x):
        out = jroute(cfg, w, x)
        jax.debug.callback(lambda i, x_, w_: rec["jax"].append(
            (np.asarray(i), _np(x_), _np(w_))), out[0], x, w)
        return out

    def port_route(cfg, w, x):
        out = proute(cfg, w, x)
        rec["port"].append(out[0].detach().numpy().copy())
        return out

    with mock.patch.object(JMOE, "route", jax_route), \
            mock.patch.object(PMOE, "route_stats", port_route):
        yield rec


def _flips(rec, k):
    """The tokens whose top-k expert sets differ between the packages (bf16
    hidden states rounded at other places reach the router).  Each must sit
    at a near-tie of JAX's own router: its k-th and (k+1)-th probabilities
    within 2**-7, one bf16 step, of the k-th."""
    jidx, x, w = rec["jax"][0]
    pidx = rec["port"][0]
    flips = [t for t in range(len(jidx)) if set(jidx[t]) != set(pidx[t])]
    logits = x.astype(np.float64) @ w.astype(np.float64)
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    for t in flips:
        top = np.sort(probs[t])[::-1]
        assert top[k - 1] - top[k] <= 2 ** -7 * top[k - 1], (t, top)
    return flips


def _batch(toks, np_mask=None):
    b = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    if np_mask is not None:
        b["loss_mask"] = np_mask
    return b


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_forward_logits_router_and_mtp_losses_match_jax(ds, act):
    """``apply`` with labels: the logits at every token whose routing
    agrees (the MoE layer is the backbone's last, so a token routed
    otherwise at a near-tie moves its own logits only), the balance loss
    and the MTP loss."""
    toks = _tokens(1)
    jm, model = ds["jm"], ds["model"]
    batch = _batch(toks)
    with _acts(jm, getattr(jnp, act)), _acts(model, getattr(torch, act)), \
            _routes() as rec, torch.no_grad():
        jl, jaux = jax.jit(jm.apply)(ds["jp"], {k: jnp.asarray(v)
                                                for k, v in batch.items()})
        pl, paux = model.apply(ds["pp"], {k: torch.as_tensor(v).long()
                                          for k, v in batch.items()})
    assert list(paux) == ["router_lb", "mtp"]
    keep = np.ones(B_ * S, bool)
    keep[_flips(rec, ds["cfg"].moe.top_k)] = False
    tol = LOGIT_TOL if act == "bfloat16" else F32_TOL
    np.testing.assert_allclose(_np(pl.float()).reshape(B_ * S, -1)[keep],
                               _np(jl).reshape(B_ * S, -1)[keep], atol=tol,
                               rtol=0)
    for name in ("router_lb", "mtp"):
        want = float(jaux[name])
        assert float(paux[name]) > 0
        tol = 1e-6 if act == "float32" else STEP_LOSS_TOL * want
        assert abs(float(paux[name]) - want) <= tol, name
    # without labels neither package computes the MTP head
    _, aux = model.apply(ds["pp"], {"tokens": torch.as_tensor(toks).long()})
    assert list(aux) == ["router_lb"]


def test_compute_loss_matches_jax(ds):
    """``compute_loss`` in f32 with a loss mask: ``total = ce + router_lb +
    0.3 · mtp`` and each part against JAX's, and ``mtp_coef`` passed
    through."""
    toks = _tokens(2)
    mask = (np.random.default_rng(3).random(toks.shape) > 0.3).astype(
        np.float32)
    batch = _batch(toks, mask)
    jm, model = ds["jm"], ds["model"]
    pb = {k: torch.as_tensor(v) for k, v in batch.items()}
    with _acts(jm, jnp.float32), _acts(model, torch.float32), \
            torch.no_grad():
        for coef in (0.3, 1.0):
            jt, jaux = jax.jit(lambda p, b: JST.compute_loss(
                jm, p, b, mtp_coef=coef))(ds["jp"], {
                    k: jnp.asarray(v) for k, v in batch.items()})
            if coef == 0.3:
                pt, paux = PST.compute_loss(model, ds["pp"], pb)
            else:
                pt, paux = PST.compute_loss(model, ds["pp"], pb,
                                            mtp_coef=coef)
            assert list(paux) == ["ce", "router_lb", "mtp"]
            for name in paux:
                want = float(jaux[name])
                assert abs(float(paux[name]) - want) <= 1e-6 * max(want, 1)
            assert abs(float(pt) - float(jt)) <= 1e-6 * float(jt)
            parts = paux["ce"] + paux["router_lb"] + coef * paux["mtp"]
            assert abs(float(pt) - float(parts)) <= 1e-6


@pytest.mark.parametrize("absorb", [False, True], ids=["expanded", "absorb"])
def test_decode_matches_forward(ds, absorb):
    """Token-by-token decode from an empty f32 cache reproduces the
    forward's logits, f32 activations, within 5e-4 (JAX's bound)."""
    model = build_model(ds["cfg"].with_(mla_absorb=absorb))
    toks = torch.as_tensor(_tokens(4), dtype=torch.int64)
    with _acts(model, torch.float32), torch.no_grad():
        full, _ = model.apply(ds["pp"], {"tokens": toks})
        cache = model.init_cache(B_, S, dtype=torch.float32)
        outs = []
        for pos in range(S):
            lg, cache = model.decode_step(ds["pp"], cache, toks[:, pos],
                                          torch.full((B_,), pos))
            outs.append(lg)
    err = float((full - torch.stack(outs, 1)).abs().max())
    assert err < F32_TOL, err


def test_prefill_matches_decode_prefix(ds):
    """The prefill's latent cache equals token-by-token decode's: last
    logits and one continuation step from each within 5e-3 (f32)."""
    model, params = ds["model"], ds["pp"]
    toks = torch.as_tensor(_tokens(5), dtype=torch.int64)
    with _acts(model, torch.float32), torch.no_grad():
        lpf, cpf = model.prefill(params, {"tokens": toks}, max_len=S + 4,
                                 cache_dtype=torch.float32)
        assert cpf["dense_blocks"]["c_kv"].shape == (1, B_, S + 4, 64)
        assert not cpf["dense_blocks"]["c_kv"][:, :, S:].any()
        cdec = model.init_cache(B_, S + 4, dtype=torch.float32)
        for pos in range(S):
            ldec, cdec = model.decode_step(params, cdec, toks[:, pos],
                                           torch.full((B_,), pos))
        assert float((lpf - ldec).abs().max()) < PREFILL_DECODE_TOL
        for stack in cpf:
            for leaf in cpf[stack]:
                assert float((cpf[stack][leaf][:, :, :S]
                              - cdec[stack][leaf][:, :, :S]).abs().max()) \
                    < PREFILL_DECODE_TOL
        nxt = torch.argmax(lpf, -1).to(torch.int32)
        l1, _ = model.decode_step(params, cpf, nxt, torch.full((B_,), S))
        l2, _ = model.decode_step(params, cdec, nxt, torch.full((B_,), S))
    assert float((l1 - l2).abs().max()) < PREFILL_DECODE_TOL


def _decode_run(model, params, toks, dtype, paged=False):
    """Teacher-forced decode of ``toks`` from an empty cache in ``dtype``
    (dense rows, or pages of 4 through a shuffled page table)."""
    B, L = toks.shape
    if paged:
        cache = model.init_paged_cache(2 * L // 4, 4, dtype=dtype)
        pages = torch.randperm(2 * L // 4, generator=torch.Generator()
                               .manual_seed(0)).to(torch.int32).reshape(B, -1)
        kw = {"pages": pages, "active": torch.ones(B, dtype=torch.bool)}
    else:
        cache = model.init_cache(B, L, dtype=dtype)
        kw = {}
    outs = []
    with _acts(model, dtype), torch.no_grad():
        for pos in range(L):
            lg, cache = model.decode_step(params, cache, toks[:, pos],
                                          torch.full((B,), pos), **kw)
            outs.append(lg.float())
    return torch.stack(outs, 1)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_absorb_matches_expanded_decode(ds, paged):
    """The absorbed decode against the expanded one, on the dense and the
    paged cache, f32 activations and caches: within ``DECODE_TOL``."""
    toks = torch.as_tensor(_tokens(6, 16), dtype=torch.int64)
    runs = [_decode_run(build_model(ds["cfg"].with_(mla_absorb=a)), ds["pp"],
                        toks, torch.float32, paged) for a in (False, True)]
    err = float((runs[0] - runs[1]).abs().max())
    assert 0 < err < DECODE_TOL, err


@pytest.mark.parametrize("absorb", [False, True], ids=["expanded", "absorb"])
def test_paged_decode_matches_dense_decode(ds, absorb):
    """The paged programs (latent pages read through a shuffled page table)
    against the dense slot rows, f32: within ``DECODE_TOL``; and JAX's
    paged decode on the same pages within ``F32_TOL``."""
    model = build_model(ds["cfg"].with_(mla_absorb=absorb))
    toks = torch.as_tensor(_tokens(7, 16), dtype=torch.int64)
    dense = _decode_run(model, ds["pp"], toks, torch.float32)
    paged = _decode_run(model, ds["pp"], toks, torch.float32, paged=True)
    assert float((dense - paged).abs().max()) < DECODE_TOL
    jm = jax_build_model(ds["jcfg"].with_(mla_absorb=absorb))
    jcache = jm.init_paged_cache(8, 4, dtype=jnp.float32)
    pages = jnp.asarray(torch.randperm(8, generator=torch.Generator()
                                       .manual_seed(0)).numpy().reshape(2, -1)
                        .astype(np.int32))
    step = jax.jit(jm.decode_step)
    outs = []
    with _acts(jm, jnp.float32):
        for pos in range(16):
            lg, jcache = step(ds["jp"], jcache, jnp.asarray(toks[:, pos]
                                                             .numpy()),
                              jnp.full((2,), pos, jnp.int32), pages=pages,
                              active=jnp.ones((2,), bool))
            outs.append(_np(lg))
    np.testing.assert_allclose(paged.numpy(), np.stack(outs, 1),
                               atol=F32_TOL, rtol=0)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
class _Capture:
    """An optimizer that keeps the gradients it is handed."""

    def update(self, grads, state, params):
        self.grads = grads
        return params, state


def _leaves_by_path(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _leaves_by_path(sub, f"{prefix}/{k}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("act", ["bfloat16", "float32"])
def test_train_step_matches_jax(ds, act):
    """One ``make_train_step`` (``remat: full``) against JAX's
    ``value_and_grad`` of ``compute_loss``: the total (cross-entropy, the
    balance loss and 0.3 × the MTP loss), its parts and every leaf's
    gradient, the MTP head's and the MLA projections' included.  A token
    routed otherwise at a near-tie (``_flips``) is masked out of both
    losses."""
    jm, pm = ds["jm"], build_model(ds["cfg"])
    toks = np.random.default_rng(8).integers(3, 512, (2, 32)).astype(np.int32)
    batch = _batch(toks)

    def both(batch):
        with _acts(jm, getattr(jnp, act)), _acts(pm, getattr(torch, act)), \
                _routes() as rec:
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
                lambda p, b: JST.compute_loss(jm, p, b), has_aux=True))(
                    ds["jp"], jb)
            cap = _Capture()
            state = {"params": params_from_jax(ds["params"]), "opt": {},
                     "step": torch.zeros((), dtype=torch.int32)}
            _, metrics = PST.make_train_step(pm, cap)(
                state, {k: torch.from_numpy(v) for k, v in batch.items()})
        return jloss, jaux, jgrads, metrics, cap, rec

    jloss, jaux, jgrads, metrics, cap, rec = both(batch)
    flips = _flips(rec, ds["cfg"].moe.top_k)
    if flips:
        mask = np.ones(toks.size, np.float32)
        mask[flips] = 0.0
        batch["loss_mask"] = mask.reshape(toks.shape)
        jloss, jaux, jgrads, metrics, cap, _ = both(batch)
    assert list(metrics) == ["ce", "loss", "mtp", "router_lb"]
    loss_tol = STEP_LOSS_TOL if act == "bfloat16" else 1e-6
    for name in ("ce", "router_lb", "mtp"):
        want = float(jaux[name])
        assert abs(float(metrics[name]) - want) <= loss_tol * want, name
    total = (float(metrics["ce"]) + float(metrics["router_lb"])
             + 0.3 * float(metrics["mtp"]))
    assert abs(total - float(jloss)) <= loss_tol * float(jloss)
    grad_tol = STEP_GRAD_TOL if act == "bfloat16" else STEP_F32_TOL
    want = _leaves_by_path(jax.tree_util.tree_map(_np, jgrads))
    got = _leaves_by_path(cap.grads)
    assert set(got) == set(want)
    assert "/mtp/proj" in want and "/mtp/block/attn/wkv_b" in want
    for path, a in want.items():
        scale = float(np.abs(a).max())
        assert scale > 0, path
        err = float(np.abs(got[path].float().numpy() - a).max())
        assert err <= grad_tol * scale, (path, err / scale)


def _doc(tmp_path, *sets):
    doc = load_yaml(QUICKSTART)
    return apply_overrides(doc, parse_overrides(
        [f"dataset.config.prefix={tmp_path / 'qs'}",
         f"run.output_dir={tmp_path / 'out'}",
         f"arch.variant_key={ARCH}", *sets]))


def test_quickstart_curve_matches_jax_gym(ds, tmp_path):
    """4 steps of the quickstart document with ``arch.variant_key=
    deepseek_v3_671b`` from JAX's initial state: JAX's gym against the
    port's on the same dataset files.  The logged rows carry ``mtp``,
    their columns in JAX's order."""
    doc = _doc(tmp_path)
    graph = {k: v for k, v in doc.items() if k != "run"}
    jax_register_all()
    register_all()
    jgym = jax_resolve_config(copy.deepcopy(graph))["gym"]
    # the module's JAX params (JAX's gym would initialise the same tree op
    # by op, 12 s on this model), fresh arrays: the step donates its state
    jp = jax.tree_util.tree_map(jnp.array, ds["params"])
    with mock.patch.object(jgym, "_init_state", lambda: {
            "params": jp, "opt": jgym.optimizer.init(jp),
            "step": jnp.zeros((), jnp.int32)}):
        jstate = jgym.setup()
    params = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    jstate["params"]))
    jout = jgym.run(4, state=jstate)
    gym = resolve_config(copy.deepcopy(graph))["gym"]
    gym.device = "cpu"
    gym.setup()
    state = {"params": params, "opt": gym.optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    out = gym.run(4, state=state)
    # the logged columns in JAX's order (its jitted step's sorted dict)
    assert list(out["history"][0]) == list(jout["history"][0])
    assert "mtp" in out["history"][0]
    for key in ("loss", "mtp"):
        np.testing.assert_allclose([h[key] for h in out["history"]],
                                   [h[key] for h in jout["history"]],
                                   atol=CURVE_TOL, rtol=0)


def test_jax_checkpoint_reads_across_and_port_writes_it_byte_equal(
        ds, tmp_path):
    """JAX's checkpoint of reduced DeepSeek-V3's train state (MLA and MTP
    leaves included; ``init_train_state``'s tree on the module's params)
    restores into the port's ``==`` the bridged arrays, and the port's
    checkpoint of it is JAX's, byte for byte."""
    jstate = jax.device_get({"params": ds["jp"],
                             "opt": JaxAdamW(lr=1e-3).init(ds["jp"]),
                             "step": jnp.zeros((), jnp.int32)})
    assert jax.tree_util.tree_structure(jstate) == jax.tree_util.\
        tree_structure(jax.eval_shape(lambda r: JST.init_train_state(
            ds["jm"], JaxAdamW(lr=1e-3), r), jax.random.PRNGKey(0)))
    jck = JCK.AsyncCheckpointer(str(tmp_path / "jax"), background=False)
    jck.save(jstate, 0)
    jdir = str(tmp_path / "jax" / "step_00000000")
    model = build_model(get_reduced(ARCH))
    like = PST.init_train_state(model, AdamW(lr=1e-3),
                                torch.Generator().manual_seed(1))
    got = restore(like, jdir)
    want = params_from_jax(jstate)
    for path, a in _leaves_by_path(want).items():
        assert torch.equal(_leaves_by_path(got)[path], a), path
    assert "/params/mtp/block/attn/kv_norm" in _leaves_by_path(got)
    ck = AsyncCheckpointer(str(tmp_path / "port"), background=False)
    ck.save(got, 0)
    pdir = str(tmp_path / "port" / "step_00000000")
    with open(f"{pdir}/manifest.json", "rb") as a, \
            open(f"{jdir}/manifest.json", "rb") as b:
        assert a.read() == b.read()
    for entry in read_manifest(jdir)["leaves"].values():
        with open(f"{pdir}/{entry['file']}", "rb") as a, \
                open(f"{jdir}/{entry['file']}", "rb") as b:
            assert a.read() == b.read(), entry["file"]


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "depth4"])
def test_lora_trainable_count_equals_jax(full):
    """LoRA's default targets on DeepSeek-V3 hit MLA's ``wo`` and the
    dense blocks' and the MTP block's MLP leaves (and the experts'): the
    adapter shapes and ``n_trainable`` are JAX's, counted on ``meta`` for
    full width at depth 4."""
    cfg = get_config(ARCH).with_(n_layers=4) if full else get_reduced(ARCH)
    jcfg = (jax_get_config(ARCH).with_(n_layers=4) if full
            else jax_get_reduced(ARCH))
    lm = LO.LoRAModel(build_model(cfg), LO.LoRAConfig(rank=8))
    jlm = JLO.LoRAModel(jax_build_model(jcfg), JLO.LoRAConfig(rank=8))
    assert _shapes(lm.adapter_shapes()) == jax.tree_util.tree_map(
        lambda a: tuple(a.shape), jlm.adapter_shapes())
    got = LO.n_trainable(lm.init(MetaGenerator()))
    assert got == JLO.n_trainable(jax.eval_shape(jlm.init,
                                                 jax.random.PRNGKey(0)))
    assert "wo" in lm.adapter_shapes()["mtp"]["block"]["attn"]
    assert "wkv_b" not in lm.adapter_shapes()["dense_blocks"]["attn"]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_cli_trains_deepseek_v3_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch train`` on the quickstart document with
    ``arch.variant_key=deepseek_v3_671b`` (reduced): two steps, the MTP
    loss logged beside the cross-entropy."""
    rc = cli_main(["train", "--config", QUICKSTART, "--device", "cpu",
                   "--set", f"arch.variant_key={ARCH}",
                   "--set", "run.train.steps=2",
                   "--set", f"dataset.config.prefix={tmp_path / 'qs'}",
                   "--set", f"run.output_dir={tmp_path / 'out'}"])
    assert rc == 0
    assert "done: 2 logged points; first loss" in capsys.readouterr().out
    with open(tmp_path / "out" / "result.json") as f:
        result = json.load(f)
    for row in result["history"]:
        assert np.isfinite(row["loss"]) and row["mtp"] > 0
    flops = ACC.model_flops(get_reduced(ARCH), SHAPES["train_4k"])[2]
    assert result["model_flops_per_step"] == 6.0 * flops * 8 * 64


def test_cli_serves_deepseek_v3_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch serve`` on ``serve.yaml`` (the static shim on
    the dense latent cache), reduced."""
    rc = cli_main(["serve", "--config", SERVE_YAML, "--device", "cpu",
                   "--set", f"arch.variant_key={ARCH}",
                   "--set", "run.serve.prompt_len=8",
                   "--set", "run.serve.gen=4",
                   "--set", "run.serve.batch=2",
                   "--set", f"run.output_dir={tmp_path / 'out'}"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "prefill:" in out and "decode:" in out
