"""GQA/MQA attention (+bias, sliding window): prefill and dense decode paths
(port of the GQA half of ``repro.models.attention``).

Long sequences (> ``_BLOCKWISE_AT``) use a blockwise online-softmax loop so
no [S, S] score tensor is ever live.  With ``cfg.use_flash_kernel`` prefill
goes through the hand-written CUDA flash kernel (its plain version on the
CPU).  Masks use ``NEG_INF = -1e30``, not ``-inf``, as the JAX package does.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from . import base as B
from .common import apply_rope, dense_init

_BLOCKWISE_AT = 4096     # use blockwise path for S strictly above this
_KV_BLOCK = 1024

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# GQA params
# ---------------------------------------------------------------------------
def init_gqa(cfg: B.ArchConfig, gen: torch.Generator, lead=()) -> Dict[str, Any]:
    """``lead`` prepends stacked dims (``(L,)`` for a layer stack)."""
    D, H, K, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    lead = tuple(lead)
    p = {
        "wq": dense_init(gen, lead + (D, H, dh), D),
        "wk": dense_init(gen, lead + (D, K, dh), D),
        "wv": dense_init(gen, lead + (D, K, dh), D),
        "wo": dense_init(gen, lead + (H, dh, D), H * dh),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", H), ("bk", K), ("bv", K)):
            p[name] = torch.zeros(lead + (n, dh), dtype=torch.float32,
                                  device=gen.device)
    return p


def _project_qkv(p, x, cfg):
    """Weights cast to the activation dtype; bias added in that dtype."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return q, k, v


def _gqa_scores_einsum(q, k):
    """q [B,S,H,dh], k [B,T,K,dh] -> scores [B,H,S,T] (grouped heads)."""
    Bq, S, H, dh = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(Bq, S, K, G, dh)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k)
    return s.reshape(Bq, K * G, S, k.shape[1])


def _gqa_out_einsum(probs, v):
    """probs [B,H,S,T], v [B,T,K,dh] -> [B,S,H,dh]."""
    Bq, H, S, T = probs.shape
    K = v.shape[2]
    G = H // K
    pg = probs.reshape(Bq, K, G, S, T)
    o = torch.einsum("bkgst,btkd->bskgd", pg, v)
    return o.reshape(Bq, S, H, v.shape[3])


def _full_attn(q, k, v, positions_q, positions_k, window: int, causal: bool):
    """Plain path; scores materialised. q [B,S,H,dh] k/v [B,T,K,dh]."""
    dh = q.shape[-1]
    scores = _gqa_scores_einsum(q, k).float() / math.sqrt(dh)
    rel = positions_q[:, None] - positions_k[None, :]  # [S, T]
    mask = torch.ones(rel.shape, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (rel >= 0)
    if window > 0:
        mask = mask & (rel < window)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    # probabilities go back to the input dtype before PV, as in JAX
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _gqa_out_einsum(probs, v)


def _blockwise_attn(q, k, v, positions_q, positions_k, window: int, causal: bool,
                    kv_block: int = _KV_BLOCK):
    """Online softmax over KV blocks; never materialises [S, T]."""
    Bq, S, H, dh = q.shape
    T = k.shape[1]
    K = k.shape[2]
    G = H // K
    qg = (q.reshape(Bq, S, K, G, dh) / math.sqrt(dh)).float()
    m = torch.full((Bq, K, G, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((Bq, K, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((Bq, K, G, S, dh), dtype=torch.float32, device=q.device)
    for lo in range(0, T, kv_block):
        # the ragged last block is sliced short here instead of padded
        # with position -1e9 keys, which only ever got probability 0
        kblk = k[:, lo:lo + kv_block]
        vblk = v[:, lo:lo + kv_block]
        pblk = positions_k[lo:lo + kv_block]
        s = torch.einsum("bskgd,btkd->bkgst", qg, kblk.float())
        rel = positions_q[:, None] - pblk[None, :]
        mask = torch.ones(rel.shape, dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (rel >= 0)
        if window > 0:
            mask = mask & (rel < window)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgst,btkd->bkgsd", p,
                                                   vblk.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(Bq, S, H, dh)
    return out.to(q.dtype)


def gqa_forward(cfg: B.ArchConfig, p, x, positions, window: Optional[int] = None,
                return_kv: bool = False):
    """Training/prefill self-attention. x [B,S,D]; positions [S]."""
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    w = cfg.window if window is None else window
    S = x.shape[1]
    if cfg.use_flash_kernel:
        from ..kernels.flash.ops import flash_attention

        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=True, window=w,
                            block_q=min(128, S), block_kv=min(128, S))
    elif S > _BLOCKWISE_AT:
        o = _blockwise_attn(q, k, v, positions, positions, w, causal=True)
    else:
        o = _full_attn(q, k, v, positions, positions, w, causal=True)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    if return_kv:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# GQA decode (single token, cache [B, L, K, dh]; ring buffer when windowed)
# ---------------------------------------------------------------------------
def gqa_init_cache(cfg: B.ArchConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None):
    K, dh = cfg.n_kv_heads, cfg.head_dim_
    L = min(max_len, cfg.window) if cfg.window > 0 else max_len
    return {
        "k": torch.zeros((batch, L, K, dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, L, K, dh), dtype=dtype, device=device),
    }


def gqa_decode(cfg: B.ArchConfig, p, cache, x, positions):
    """x [B,1,D]; positions [B]; returns (out [B,1,D], cache).

    The cache is updated in place (JAX donated it and returned a new one).
    Every slot writes at its own position, also a slot whose request is
    inactive: its position is frozen, and the next admission overwrites the
    whole slot row.
    """
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope(q, positions[:, None], cfg.rope_theta)
    k = apply_rope(k, positions[:, None], cfg.rope_theta)
    L = cache["k"].shape[1]
    slot = positions % L if cfg.window > 0 else positions
    bidx = torch.arange(x.shape[0], device=x.device)
    ck, cv = cache["k"], cache["v"]
    ck[bidx, slot] = k[:, 0].to(ck.dtype)
    cv[bidx, slot] = v[:, 0].to(cv.dtype)

    dh = q.shape[-1]
    scores = _gqa_scores_einsum(q, ck).float() / math.sqrt(dh)      # [B,H,1,L]
    n_valid = torch.clamp(positions + 1, max=L)                      # [B]
    valid = torch.arange(L, device=x.device)[None, :] < n_valid[:, None]  # [B,L]
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    o = _gqa_out_einsum(probs, cv)                                   # [B,1,H,dh]
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    return out, cache
