"""Attention: GQA/MQA (+bias, sliding window) and MLA (DeepSeek-V3's
latent KV compression), each with prefill, dense decode and paged
(block-pool) decode and chunked-prefill paths, and the encoder-decoder's
bidirectional and cross attention (port of ``repro.models.attention``).

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
from .common import apply_rope, dense_init, rmsnorm

_BLOCKWISE_AT = 4096     # use blockwise path for S strictly above this
_KV_BLOCK = 1024
_MLA_KV_BLOCK = 512

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


def gqa_axes(cfg: B.ArchConfig) -> Dict[str, Any]:
    p = {
        "wq": (B.D_MODEL, B.HEADS, B.HEAD_DIM),
        "wk": (B.D_MODEL, B.KV_HEADS, B.HEAD_DIM),
        "wv": (B.D_MODEL, B.KV_HEADS, B.HEAD_DIM),
        "wo": (B.HEADS, B.HEAD_DIM, B.D_MODEL),
    }
    if cfg.qkv_bias:
        p["bq"] = (B.HEADS, B.HEAD_DIM)
        p["bk"] = (B.KV_HEADS, B.HEAD_DIM)
        p["bv"] = (B.KV_HEADS, B.HEAD_DIM)
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

    def attend(q, k, v):
        # contiguous gradients on every path: a DTensor block's must be
        # (B.local_call), and the run with no mesh then sums them in the
        # same order as the run under a mesh
        q, k, v = (B.contiguous_grad(t) for t in (q, k, v))
        if cfg.use_flash_kernel:
            from ..kernels.flash.ops import flash_attention

            return flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=True, window=w,
                                   block_q=min(128, S), block_kv=min(128, S))
        if S > _BLOCKWISE_AT:
            return _blockwise_attn(q, k, v, positions, positions, w,
                                   causal=True)
        return _full_attn(q, k, v, positions, positions, w, causal=True)

    o = _local_heads(attend, q, k, v) if B.is_dtensor(q) else attend(q, k, v)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    if return_kv:
        return out, (k, v)
    return out


def _local_heads(attend, q, k, v):
    """``attend(q, k, v)`` on each rank's local batch rows and local query
    heads, under a mesh (``B.local_call``): the kernel sees plain tensors.

    Where the KV heads shard over the same mesh dims as the query heads,
    the local groups line up.  A KV leaf whose heads do not divide the
    ``model`` axis stays replicated while the query heads shard (Granite's
    single KV head, ``leaf_spec``'s warning): each rank then takes the
    global KV heads of its own query heads' groups, and the KV gradient is
    a partial sum over those mesh dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = q.device_mesh
    H, K = q.shape[2], k.shape[2]
    G = H // K
    qp, kp, kg, head_dims = [], [], [], []
    for i, (pq, pk) in enumerate(zip(q.placements, k.placements)):
        if isinstance(pq, Shard) and pq.dim == 0:
            qp.append(Shard(0))
            kp.append(Shard(0))
            kg.append(Shard(0))
        elif isinstance(pq, Shard) and pq.dim == 2:
            qp.append(Shard(2))
            if isinstance(pk, Shard) and pk.dim == 2:
                kp.append(Shard(2))
                kg.append(Shard(2))
            else:
                head_dims.append(i)
                kp.append(Replicate())
                kg.append(Partial())
        else:
            qp.append(Replicate())
            kp.append(Replicate())
            kg.append(Replicate())
    sel = None
    if head_dims:
        # the query heads shard over the TP axis alone; this rank's block
        coord = mesh.get_coordinate()
        c, n = 0, 1
        for i in head_dims:
            c, n = c * mesh.shape[i] + coord[i], n * mesh.shape[i]
        h_local = H // n
        groups = [(c * h_local + j) // G for j in range(h_local)]
        uniq = sorted(set(groups))
        # whole groups (or one group's share) keep the kernel's grouping;
        # otherwise each local head takes its own KV head
        even = all(groups.count(g) * len(uniq) == h_local for g in uniq)
        sel = uniq if even else groups

    def local(ql, kl, vl):
        if sel is not None:
            idx = torch.tensor(sel, device=kl.device)
            kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
        return attend(ql, kl, vl)

    return B.local_call(local, (q, k, v), (qp, kp, kp), (qp, kg, kg), qp)


def bidir_forward(cfg: B.ArchConfig, p, x):
    """Bidirectional (encoder) self-attention, no rope (Whisper's positions
    are learned).  The plain path, as in JAX: no kernel."""
    q, k, v = _project_qkv(p, x, cfg)
    pos = torch.arange(x.shape[1], device=x.device)
    o = _full_attn(q, k, v, pos, pos, window=0, causal=False)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))


def cross_forward(cfg: B.ArchConfig, p, x, enc_kv):
    """Cross-attention: q from x, k/v precomputed from the encoder's output
    (``cross_kv``)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
    k, v = enc_kv
    pos_q = torch.arange(x.shape[1], device=x.device)
    pos_k = torch.arange(k.shape[1], device=x.device)
    o = _full_attn(q, k, v, pos_q, pos_k, window=0, causal=False)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))


def cross_kv(cfg: B.ArchConfig, p, enc_out):
    """The cross-attention's k/v of the encoder's output ``[B, F, D]``."""
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"].to(enc_out.dtype))
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"].to(enc_out.dtype))
    if cfg.qkv_bias:
        k = k + p["bk"].to(enc_out.dtype)
        v = v + p["bv"].to(enc_out.dtype)
    return k, v


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


# ---------------------------------------------------------------------------
# Paged KV cache (serving): [n_blocks + 1, block_len, ...] leaves + page tables
# ---------------------------------------------------------------------------
# The serve engine's block allocator hands each request a row of physical
# block ids; attention reads the cache *through* that row (gather) and
# writes the current token's K/V into (block, offset) = (row[pos // bl],
# pos % bl) (scatter).  JAX gathers clamp out-of-range indices and wrap
# negative ones, and JAX scatters drop out-of-range writes; PyTorch raises
# on the CPU and trips a device-side assert on the card.  So every such
# index is made explicit here, with no host sync and no data-dependent
# shape:
#
# - the pool holds one scratch block past the ``n_blocks`` the allocator
#   owns, which no page table names.  A suppressed write (an inactive
#   slot, a padding row of a prefill chunk) goes there instead of being
#   dropped, and a page table's -1 (unallocated) wraps to it on a read.
#   Its values are finite (K/V rows, or the pool's initial zeros) and are
#   only ever read behind the causal/validity mask, where softmax gives
#   them exactly-0 probability (``docs/serving.md``, "finite garbage");
# - a page index ``pos // bl`` past the page table (a retired slot's
#   frozen ``pos == max_len``, a padding row) is clamped, and its write
#   goes to the scratch block.


def scratch_block(leaf) -> int:
    """The pool's scratch block (the last one): where suppressed writes go."""
    return leaf.shape[0] - 1


def paged_view(leaf, pages):
    """Gather ``leaf [n_blocks + 1, bl, ...]`` through ``pages [..., n_pages]``
    into a contiguous view ``[..., n_pages * bl, ...]``."""
    v = leaf[pages.long()]
    lead = tuple(pages.shape[:-1])
    return v.reshape(lead + (pages.shape[-1] * leaf.shape[1],)
                     + tuple(leaf.shape[2:]))


def _paged_write(leaf, phys, off, vals):
    """Write ``vals [N, ...]`` rows into ``leaf[phys[i], off[i]]`` in place
    (``phys`` is the scratch block for a suppressed write)."""
    leaf.index_put_((phys.long(), off.long()), vals.to(leaf.dtype))


def gqa_init_paged_cache(cfg: B.ArchConfig, n_blocks: int, block_len: int,
                         dtype=torch.bfloat16, device=None):
    """``n_blocks`` pages and the scratch block, zeroed (a masked entry's
    probability is exactly 0, and 0 x finite stays 0)."""
    K, dh = cfg.n_kv_heads, cfg.head_dim_
    shape = (n_blocks + 1, block_len, K, dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _page_of(pages, positions, bl):
    """Physical block of each position: ``pages[..., positions // bl]``, the
    page index clamped to the table (JAX's gather clamps it)."""
    idx = torch.clamp(positions // bl, max=pages.shape[-1] - 1).long()
    if pages.dim() == 1:
        return pages[idx]
    return torch.gather(pages, 1, idx[:, None])[:, 0]


def gqa_decode_paged(cfg: B.ArchConfig, p, cache, x, positions, pages,
                     active=None):
    """Single-token GQA decode through page tables.

    x [B,1,D]; positions [B]; pages int32 [B, n_pages] physical block ids
    per slot; active bool [B] suppresses cache writes for dead slots (their
    frozen positions may alias pages since freed and reused).  The cache is
    updated in place and returned."""
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope(q, positions[:, None], cfg.rope_theta)
    k = apply_rope(k, positions[:, None], cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    bl = ck.shape[1]
    phys = _page_of(pages, positions, bl)
    if active is not None:
        phys = torch.where(active, phys, scratch_block(ck))
    _paged_write(ck, phys, positions % bl, k[:, 0])
    _paged_write(cv, phys, positions % bl, v[:, 0])
    vk = paged_view(ck, pages)                                   # [B,T,K,dh]
    vv = paged_view(cv, pages)
    dh = q.shape[-1]
    scores = _gqa_scores_einsum(q, vk).float() / math.sqrt(dh)
    T = vk.shape[1]
    valid = (torch.arange(T, device=x.device)[None, :]
             < (positions + 1)[:, None])                         # [B,T]
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    o = _gqa_out_einsum(probs, vv)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    return out, cache


def gqa_prefill_chunk(cfg: B.ArchConfig, p, cache, x, positions, pages_row,
                      n_valid: int):
    """One fixed-shape prefill chunk: C prompt rows into one request's pages.

    x [1,C,D]; positions [C] absolute; pages_row int32 [n_pages]; rows at
    index >= n_valid are padding (writes suppressed, outputs garbage).  The
    chunk's shapes never depend on the prompt length, so a page's stored K/V
    is bitwise identical whether the prompt was short or long, cold or a
    cache hit — the canonical-page property the radix index shares under.
    """
    q, k, v = _project_qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    bl = ck.shape[1]
    row_idx = torch.arange(positions.shape[0], device=x.device)
    phys = torch.where(row_idx < n_valid, _page_of(pages_row, positions, bl),
                       scratch_block(ck))
    _paged_write(ck, phys, positions % bl, k[0])
    _paged_write(cv, phys, positions % bl, v[0])
    vk = paged_view(ck, pages_row[None])                        # [1,T,K,dh]
    vv = paged_view(cv, pages_row[None])
    dh = q.shape[-1]
    scores = _gqa_scores_einsum(q, vk).float() / math.sqrt(dh)
    T = vk.shape[1]
    valid = (positions[:, None]
             >= torch.arange(T, device=x.device)[None, :])      # [C,T] causal
    scores = torch.where(valid[None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    o = _gqa_out_einsum(probs, vv)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    return out, cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3): latent KV compression
# ---------------------------------------------------------------------------
# The cache holds one latent row a token (``c_kv [kv_lora]``, normed) and
# one rope key shared by every head (``k_rope [head_dim_rope]``); attention
# expands the latent to per-head ``k_nope``/``v`` through ``wkv_b``, or,
# with ``absorb``, folds ``wkv_b`` into the query and output sides and
# scores in the latent space.  The scale is ``1/sqrt(nope + rope)``, the
# query's width, whatever ``cfg.head_dim`` says.  As in JAX, no path reaches
# the flash kernel: the products are einsums (qk width 192, v width 128 at
# full size).
def init_mla(cfg: B.ArchConfig, gen: torch.Generator, lead=()) -> Dict[str, Any]:
    """JAX's tree and shapes; ``lead`` prepends stacked dims."""
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    lead = tuple(lead)

    def ones(n):
        return torch.ones(lead + (n,), dtype=torch.float32, device=gen.device)

    return {
        "wq_a": dense_init(gen, lead + (D, m.q_lora), D),
        "q_norm": ones(m.q_lora),
        "wq_b": dense_init(gen, lead + (m.q_lora, H, m.head_dim_nope
                                       + m.head_dim_rope), m.q_lora),
        "wkv_a": dense_init(gen, lead + (D, m.kv_lora + m.head_dim_rope), D),
        "kv_norm": ones(m.kv_lora),
        "wkv_b": dense_init(gen, lead + (m.kv_lora, H, m.head_dim_nope
                                        + m.head_dim_v), m.kv_lora),
        "wo": dense_init(gen, lead + (H, m.head_dim_v, D), H * m.head_dim_v),
    }


def mla_axes(cfg: B.ArchConfig) -> Dict[str, Any]:
    return {
        "wq_a": (B.D_MODEL, B.LORA),
        "q_norm": (B.LORA,),
        "wq_b": (B.LORA, B.HEADS, B.HEAD_DIM),
        "wkv_a": (B.D_MODEL, B.LORA),
        "kv_norm": (B.LORA,),
        "wkv_b": (B.LORA, B.HEADS, B.HEAD_DIM),
        "wo": (B.HEADS, B.HEAD_DIM, B.D_MODEL),
    }


def _mla_scale(cfg) -> float:
    m = cfg.mla
    return 1.0 / math.sqrt(m.head_dim_nope + m.head_dim_rope)


def _mla_qkv(cfg, p, x, positions):
    """x [B,S,D] -> (q_nope [B,S,H,dn], q_rope [B,S,H,dr], c_kv [B,S,r],
    k_rope [B,S,dr]); ``k_rope`` is one head, roped as ``[B,S,1,dr]``."""
    m = cfg.mla
    cq = torch.einsum("bsd,dr->bsr", x, p["wq_a"].to(x.dtype))
    cq = rmsnorm(cq, p["q_norm"], cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", cq, p["wq_b"].to(x.dtype))
    q_nope, q_rope = torch.split(q, [m.head_dim_nope, m.head_dim_rope], -1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    ckv = torch.einsum("bsd,dr->bsr", x, p["wkv_a"].to(x.dtype))
    c_kv, k_rope = torch.split(ckv, [m.kv_lora, m.head_dim_rope], -1)
    c_kv = rmsnorm(c_kv, p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def _mla_expand_kv(cfg, p, c_kv):
    """Latent ``c_kv [B,T,r]`` -> (k_nope [B,T,H,dn], v [B,T,H,dv])."""
    m = cfg.mla
    kv = torch.einsum("bsr,rhk->bshk", c_kv, p["wkv_b"].to(c_kv.dtype))
    return torch.split(kv, [m.head_dim_nope, m.head_dim_v], -1)


def _mla_attend(cfg, p, q_nope, q_rope, c_kv, k_rope, valid, dtype):
    """The expanded path: scores of the queries against the latent rows
    ``c_kv [B,T,r]``/``k_rope [B,T,dr]`` (both in ``dtype``), summed in
    ``dtype`` and scaled in f32, masked by ``valid`` (broadcast to [B,H,S,
    T]), probabilities rounded to ``dtype`` before PV, as in JAX."""
    k_nope, v = _mla_expand_kv(cfg, p, c_kv)
    s = torch.einsum("bshk,bthk->bhst", q_nope, k_nope)
    s = s + torch.einsum("bshk,btk->bhst", q_rope, k_rope)
    s = (s.float() * _mla_scale(cfg)).masked_fill(~valid, NEG_INF)
    probs = torch.softmax(s, dim=-1).to(dtype)
    return torch.einsum("bhst,bthk->bshk", probs, v)


def mla_forward(cfg: B.ArchConfig, p, x, positions, return_latent: bool = False):
    """Training/prefill MLA self-attention (blockwise over KV for long S)."""
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(cfg, p, x, positions)
    if x.shape[1] <= _BLOCKWISE_AT:
        causal = (positions[:, None] - positions[None, :]) >= 0     # [S, T]
        o = _mla_attend(cfg, p, q_nope, q_rope, c_kv, k_rope, causal, x.dtype)
    else:
        o = _mla_blockwise(cfg, p, q_nope, q_rope, c_kv, k_rope, positions,
                           _mla_scale(cfg))
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    if return_latent:
        return out, (c_kv, k_rope)
    return out


def _mla_blockwise(cfg, p, q_nope, q_rope, c_kv, k_rope, positions, scale,
                   kv_block: int = _MLA_KV_BLOCK):
    """Blockwise MLA: the latent expanded to k/v one block at a time, an
    online softmax in f32 over the blocks."""
    m = cfg.mla
    Bq, S, H, _ = q_nope.shape
    T = c_kv.shape[1]
    qn, qr = q_nope.float(), q_rope.float()
    dev = q_nope.device
    mx = torch.full((Bq, H, S), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((Bq, H, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((Bq, H, S, m.head_dim_v), dtype=torch.float32,
                      device=dev)
    for lo in range(0, T, kv_block):
        # the ragged last block is sliced short here instead of padded with
        # position -1e9 rows, which only ever got probability 0
        k_nope, v = _mla_expand_kv(cfg, p, c_kv[:, lo:lo + kv_block])
        s = torch.einsum("bshk,bthk->bhst", qn, k_nope.float())
        s = s + torch.einsum("bshk,btk->bhst", qr,
                             k_rope[:, lo:lo + kv_block].float())
        s = s * scale
        pblk = positions[lo:lo + kv_block]
        s = s.masked_fill((positions[:, None] - pblk[None, :]) < 0, NEG_INF)
        m_new = torch.maximum(mx, s.amax(dim=-1))
        pr = torch.exp(s - m_new[..., None])
        corr = torch.exp(mx - m_new)
        l = l * corr + pr.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhst,bthk->bhsk", pr,
                                                   v.float())
        mx = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q_nope.dtype)               # [B,S,H,dv]


def mla_init_cache(cfg: B.ArchConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None):
    m = cfg.mla
    return {
        "c_kv": torch.zeros((batch, max_len, m.kv_lora), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((batch, max_len, m.head_dim_rope), dtype=dtype,
                              device=device),
    }


def _mla_absorbed(cfg, p, q_nope, q_rope, c_kv, k_rope, valid, dtype):
    """The absorbed path: ``wkv_b`` split into ``wk``/``wv`` and folded into
    the query (``q_lat = q_nope·wk``) and output sides, so the scores and
    the weighted sum run against the raw latent rows, with no per-step K/V
    expansion.  The latent keeps the cache's dtype; mixed operands compute
    in their promoted dtype, as JAX's einsums promote."""
    m = cfg.mla
    wk, wv = torch.split(p["wkv_b"].to(dtype),
                         [m.head_dim_nope, m.head_dim_v], -1)
    dt = torch.promote_types(dtype, c_kv.dtype)
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, wk)              # [B,1,H,r]
    s = torch.einsum("bshr,btr->bhst", q_lat.to(dt), c_kv.to(dt))
    s = s + torch.einsum("bshk,btk->bhst", q_rope.to(dt), k_rope.to(dt))
    s = (s.float() * _mla_scale(cfg)).masked_fill(~valid, NEG_INF)
    probs = torch.softmax(s, dim=-1).to(dtype)
    o_lat = torch.einsum("bhst,btr->bshr", probs.to(dt), c_kv.to(dt))
    return torch.einsum("bshr,rhk->bshk", o_lat, wv.to(dt))         # [B,1,H,dv]


def _mla_decode_attend(cfg, p, q_nope, q_rope, c_kv, k_rope, valid, dtype,
                       absorb):
    """One query token against a cache view (dense rows or gathered pages)
    with validity ``valid [B,T]``; the expanded path casts the view to the
    activations' dtype first, as JAX's ``mla_decode``."""
    valid = valid[:, None, None, :]
    if absorb:
        return _mla_absorbed(cfg, p, q_nope, q_rope, c_kv, k_rope, valid,
                             dtype)
    return _mla_attend(cfg, p, q_nope, q_rope, c_kv.to(dtype),
                       k_rope.to(dtype), valid, dtype)


def _wo(p, x, o):
    """``wo`` in the activations' dtype, promoted to ``o``'s (an absorbed
    output against an f32 cache is f32 under bf16 activations)."""
    return p["wo"].to(x.dtype).to(o.dtype)


def mla_decode(cfg: B.ArchConfig, p, cache, x, positions, absorb: bool = False):
    """Single-token MLA decode against the latent cache: x [B,1,D],
    positions [B]; the cache is updated in place (every slot writes at its
    own position, as ``gqa_decode``)."""
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(cfg, p, x, positions[:, None])
    cc, cr = cache["c_kv"], cache["k_rope"]
    bidx = torch.arange(x.shape[0], device=x.device)
    cc[bidx, positions] = c_kv[:, 0].to(cc.dtype)
    cr[bidx, positions] = k_rope[:, 0].to(cr.dtype)
    L = cc.shape[1]
    valid = torch.arange(L, device=x.device)[None, :] <= positions[:, None]
    o = _mla_decode_attend(cfg, p, q_nope, q_rope, cc, cr, valid, x.dtype,
                           absorb)
    out = torch.einsum("bshk,hkd->bsd", o, _wo(p, x, o))
    return out, cache


def mla_init_paged_cache(cfg: B.ArchConfig, n_blocks: int, block_len: int,
                         dtype=torch.bfloat16, device=None):
    """``n_blocks`` latent pages and the scratch block, zeroed."""
    m = cfg.mla
    return {
        "c_kv": torch.zeros((n_blocks + 1, block_len, m.kv_lora), dtype=dtype,
                            device=device),
        "k_rope": torch.zeros((n_blocks + 1, block_len, m.head_dim_rope),
                              dtype=dtype, device=device),
    }


def mla_decode_paged(cfg: B.ArchConfig, p, cache, x, positions, pages,
                     active=None, absorb: bool = False):
    """Single-token MLA decode against the paged latent cache (the page
    conventions of ``gqa_decode_paged``)."""
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(cfg, p, x, positions[:, None])
    cc, cr = cache["c_kv"], cache["k_rope"]
    bl = cc.shape[1]
    phys = _page_of(pages, positions, bl)
    if active is not None:
        phys = torch.where(active, phys, scratch_block(cc))
    _paged_write(cc, phys, positions % bl, c_kv[:, 0])
    _paged_write(cr, phys, positions % bl, k_rope[:, 0])
    vc = paged_view(cc, pages)                                   # [B,T,r]
    vr = paged_view(cr, pages)
    T = vc.shape[1]
    valid = torch.arange(T, device=x.device)[None, :] <= positions[:, None]
    o = _mla_decode_attend(cfg, p, q_nope, q_rope, vc, vr, valid, x.dtype,
                           absorb)
    out = torch.einsum("bshk,hkd->bsd", o, _wo(p, x, o))
    return out, cache


def mla_prefill_chunk(cfg: B.ArchConfig, p, cache, x, positions, pages_row,
                      n_valid: int):
    """One fixed-shape MLA prefill chunk (see ``gqa_prefill_chunk``)."""
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(cfg, p, x, positions)
    cc, cr = cache["c_kv"], cache["k_rope"]
    bl = cc.shape[1]
    row_idx = torch.arange(positions.shape[0], device=x.device)
    phys = torch.where(row_idx < n_valid, _page_of(pages_row, positions, bl),
                       scratch_block(cc))
    _paged_write(cc, phys, positions % bl, c_kv[0])
    _paged_write(cr, phys, positions % bl, k_rope[0])
    vc = paged_view(cc, pages_row[None])                         # [1,T,r]
    vr = paged_view(cr, pages_row[None])
    T = vc.shape[1]
    causal = (positions[:, None]
              >= torch.arange(T, device=x.device)[None, :])      # [C,T]
    o = _mla_attend(cfg, p, q_nope, q_rope, vc.to(x.dtype), vr.to(x.dtype),
                    causal, x.dtype)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(x.dtype))
    return out, cache
