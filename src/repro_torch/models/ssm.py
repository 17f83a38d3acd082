"""Mamba2 (SSD, state-space duality) blocks: chunked prefill scan and O(1)
decode (port of ``repro.models.ssm``).

Prefill runs the chunked SSD scan through ``kernels.ssd.ops.ssd_scan``: the
hand-written CUDA kernel for tensors on the card, its plain version
(``ssd_chunked``, re-exported here) for tensors on the CPU.  JAX computes the
same function with ``ssd_chunked`` in ``ssm_forward``; its Pallas kernel
tiles that function's inner body.  Decode is the plain recurrence on a
persistent (conv, ssm) state: no KV cache, O(1) in context length.
[arXiv:2405.21060]
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..kernels.ssd.ops import ssd_scan
from ..kernels.ssd.ref import ssd_chunked  # noqa: F401  (re-export)
from . import base as B
from .common import dense_init, rmsnorm


def ssm_dims(cfg: B.ArchConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, H, conv_dim


def _uniform(gen, shape, lo, hi):
    out = torch.rand(tuple(shape), dtype=torch.float32, device=gen.device,
                     generator=gen)
    return lo + (hi - lo) * out


def init_ssm(cfg: B.ArchConfig, gen: torch.Generator, lead=()) -> Dict[str, Any]:
    """``lead`` prepends stacked dims (``(L,)`` for a layer stack)."""
    s = cfg.ssm
    D = cfg.d_model
    d_inner, H, conv_dim = ssm_dims(cfg)
    proj_out = 2 * d_inner + 2 * s.n_groups * s.d_state + H
    lead = tuple(lead)
    dev = gen.device
    return {
        "in_proj": dense_init(gen, lead + (D, proj_out), D),
        "conv_w": dense_init(gen, lead + (s.d_conv, conv_dim), s.d_conv),
        "conv_b": torch.zeros(lead + (conv_dim,), dtype=torch.float32,
                              device=dev),
        "A_log": torch.log(_uniform(gen, lead + (H,), 1.0, 16.0)),
        "D": torch.ones(lead + (H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.log(torch.exp(
            _uniform(gen, lead + (H,), 1e-3, 0.1)) - 1.0),
        "norm": torch.ones(lead + (d_inner,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, lead + (d_inner, D), d_inner),
    }


def ssm_axes(cfg: B.ArchConfig) -> Dict[str, Any]:
    return {
        "in_proj": (B.D_MODEL, B.D_INNER),
        "conv_w": (None, B.CONV_DIM),
        "conv_b": (B.CONV_DIM,),
        "A_log": (None,),
        "D": (None,),
        "dt_bias": (None,),
        "norm": (B.D_INNER,),
        "out_proj": (B.D_INNER, B.D_MODEL),
    }


def _split_proj(cfg, zxbcdt):
    """z, x, B, C, dt (views); ``torch.split`` takes sizes where
    ``jnp.split`` takes cut points."""
    s = cfg.ssm
    d_inner, H, _ = ssm_dims(cfg)
    gn = s.n_groups * s.d_state
    return torch.split(zxbcdt, [d_inner, d_inner, gn, gn, H], dim=-1)


def _causal_conv(x, w, b):
    """Depthwise causal conv. x [B,S,C], w [W,C].  The shifted products are
    summed in x's dtype, in JAX's order, from 0."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = 0
    for i in range(W):
        out = out + xp[:, i:i + x.shape[1], :] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` everywhere (``F.softplus``
    switches to the identity above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def ssm_forward(cfg: B.ArchConfig, p, x, return_state: bool = False):
    """Full Mamba2 block body (pre-norm residual handled by the caller).

    x [B,S,D] -> y [B,S,D] (+ the decode-ready state when ``return_state``).
    The scan goes through ``ssd_scan`` with ``chunk = min(s.chunk, S)``, so
    S must be a multiple of that chunk, as in JAX.  Under a mesh (DTensor
    activations) the projections run on DTensors and the mixer between
    them (:func:`_mixer`, the scan included) on each rank's local rows.
    """
    zxbcdt = torch.einsum("bsd,de->bse", x, p["in_proj"].to(x.dtype))
    if B.is_dtensor(zxbcdt):
        y, conv_raw, h_final = _local_mixer(cfg, p, zxbcdt, return_state)
    else:
        y, xBC_raw, h_final = _mixer(cfg, zxbcdt, p["conv_w"], p["conv_b"],
                                     p["dt_bias"], p["A_log"], p["D"],
                                     p["norm"])
        conv_raw = xBC_raw[:, -(cfg.ssm.d_conv - 1):, :]
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(x.dtype))
    if return_state:
        return out, {"conv": conv_raw.float(), "ssm": h_final}
    return out


def _mixer(cfg, zxbcdt, conv_w, conv_b, dt_bias, A_log, D, norm):
    """Between the projections: split, causal conv, the SSD scan, the gated
    norm.  Returns (the gated, normed scan output ``[B, S, d_inner]``, the
    conv's input, the scan's final state)."""
    s = cfg.ssm
    d_inner, H, conv_dim = ssm_dims(cfg)
    z, xs, Bm, Cm, dt = _split_proj(cfg, zxbcdt)
    xBC_raw = torch.cat([xs, Bm, Cm], dim=-1)
    xBC = F.silu(_causal_conv(xBC_raw, conv_w, conv_b))
    gn = s.n_groups * s.d_state
    xs, Bm, Cm = torch.split(xBC, [d_inner, gn, gn], dim=-1)
    dt = _softplus(dt.float() + dt_bias)
    A = -torch.exp(A_log)
    Bq, S, _ = zxbcdt.shape
    # views of xBC: the kernel reads them through their strides
    xs = xs.reshape(Bq, S, H, s.head_dim)
    Bm = Bm.reshape(Bq, S, s.n_groups, s.d_state)
    Cm = Cm.reshape(Bq, S, s.n_groups, s.d_state)
    y, h_final = ssd_scan(xs, dt, A, Bm, Cm, D, chunk=min(s.chunk, S))
    y = y.reshape(Bq, S, d_inner)
    return rmsnorm(y * F.silu(z), norm, cfg.norm_eps), xBC_raw, h_final


def _local_mixer(cfg, p, zxbcdt, return_state: bool = False):
    """:func:`_mixer` on each rank's local batch rows (``B.local_call``),
    the same ops as on one device: the projection's output is gathered over
    every mesh dim but the batch's (the split's cut points do not fall on
    its TP shards, so DTensor's split would gather it too), and the mixer's
    params are replicated.  Each rank reads them for its own rows, so their
    gradients are partial sums over the batch's mesh dims.  Returns (the
    mixer's output, then with ``return_state`` the conv's last ``d_conv -
    1`` inputs and the scan's final state, else None twice)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    rows = [isinstance(q, Shard) and q.dim == 0 for q in zxbcdt.placements]
    act = [Shard(0) if r else Replicate() for r in rows]
    rep = [Replicate()] * len(rows)
    par = [Partial() if r else Replicate() for r in rows]
    names = ("conv_w", "conv_b", "dt_bias", "A_log", "D", "norm")

    w = cfg.ssm.d_conv - 1

    def mixer(zx, *params):
        y, xbc, h_final = _mixer(cfg, zx, *params)
        return (y, xbc[:, -w:, :], h_final) if return_state else y

    out = B.local_call(mixer, (zxbcdt,) + tuple(p[k] for k in names),
                       (act,) + (rep,) * len(names),
                       (act,) + (par,) * len(names),
                       (act, act, act) if return_state else act)
    return out if return_state else (out, None, None)


# ---------------------------------------------------------------------------
# decode: O(1) recurrent state
# ---------------------------------------------------------------------------
def ssm_init_state(cfg: B.ArchConfig, batch: int, dtype=torch.float32,
                   device=None):
    """The decode state; the ssm part is f32 whatever ``dtype`` says."""
    s = cfg.ssm
    d_inner, H, conv_dim = ssm_dims(cfg)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, H, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }


def ssm_decode(cfg: B.ArchConfig, p, state, x):
    """x [B,1,D] -> (y [B,1,D], state).  The state is updated in place (JAX
    returned a new one) and returned; under a mesh on each rank's own block
    of it (:func:`_mesh_decode`)."""
    s = cfg.ssm
    d_inner, H, conv_dim = ssm_dims(cfg)
    zxbcdt = torch.einsum("bsd,de->bse", x, p["in_proj"].to(x.dtype))
    if B.is_dtensor(zxbcdt):
        return _mesh_decode(cfg, p, state, x, zxbcdt), state
    xBC, conv_new = _conv_step(cfg, zxbcdt, state["conv"], p["conv_w"],
                               p["conv_b"], x.dtype)
    y, h = _ssm_step(cfg, xBC, zxbcdt, state["ssm"], p["dt_bias"],
                     p["A_log"], p["D"], 0, H)
    y = y.reshape(-1, 1, d_inner).to(x.dtype)
    z = _split_proj(cfg, zxbcdt)[0]
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(x.dtype))
    state["conv"].copy_(conv_new)
    state["ssm"].copy_(h)
    return out, state


def _conv_step(cfg, zxbcdt, conv, conv_w, conv_b, dtype, c0: int = 0):
    """The conv ring's step over the channels ``[c0, c0 + conv.shape[-1])``
    (the conv is depthwise: each channel reads its own history): (the
    conv's output on them, the ring's new contents)."""
    _, xs, Bm, Cm, _ = _split_proj(cfg, zxbcdt)
    xBC_new = torch.cat([xs, Bm, Cm], dim=-1)[:, 0]               # [B, conv_dim]
    xBC_new = xBC_new[:, c0:c0 + conv.shape[-1]]
    # conv ring: the state holds the last W-1 inputs
    hist = torch.cat([conv, xBC_new[:, None, :].to(conv.dtype)], dim=1)
    xBC = torch.einsum("bwc,wc->bc", hist.to(dtype), conv_w.to(dtype)) \
        + conv_b.to(dtype)
    return xBC, hist[:, 1:]


def _ssm_step(cfg, xBC, zxbcdt, h0, dt_bias, A_log, D, lo: int, n: int):
    """The recurrence's step for heads ``[lo, lo + n)`` from the conv's
    output over every channel: (y ``[B, n, P]`` f32, the new state of those
    heads).  ``dt_bias``, ``A_log`` and ``D`` are those heads' own."""
    s = cfg.ssm
    d_inner, H, _ = ssm_dims(cfg)
    dt = _split_proj(cfg, zxbcdt)[4]
    xBC = F.silu(xBC)
    gn = s.n_groups * s.d_state
    xs1, Bm1, Cm1 = torch.split(xBC, [d_inner, gn, gn], dim=-1)
    dt1 = _softplus(dt[:, 0, lo:lo + n].float() + dt_bias)        # [B,n]
    A = -torch.exp(A_log)
    xs1 = xs1.reshape(-1, H, s.head_dim)[:, lo:lo + n].float()
    Bm1 = Bm1.reshape(-1, s.n_groups, s.d_state).float()
    Cm1 = Cm1.reshape(-1, s.n_groups, s.d_state).float()
    rep = H // s.n_groups
    Bh = Bm1.repeat_interleave(rep, dim=1)[:, lo:lo + n]          # [B,n,N]
    Ch = Cm1.repeat_interleave(rep, dim=1)[:, lo:lo + n]
    dA = torch.exp(dt1 * A)                                       # [B,n]
    h = h0 * dA[:, :, None, None] + torch.einsum(
        "bhn,bhp,bh->bhpn", Bh, xs1, dt1)
    y = torch.einsum("bhpn,bhn->bhp", h, Ch) + D[None, :, None] * xs1
    return y, h


def _mesh_decode(cfg, p, state, x, zxbcdt):
    """:func:`ssm_decode` under a mesh, on each rank's block of the state
    laid out by ``plans.cache_shardings``: its slots (``conv`` and ``ssm``
    dim 0), its channels of the conv ring (``conv`` dim 2 over ``model``)
    and its heads of the recurrence (``ssm`` dim 1 over ``model``), as
    :func:`_local_mixer` runs the forward on each rank's rows.  The
    projection's output is gathered over every mesh dim but the slots'
    (an activation of one token a slot); each rank steps the conv on its
    channels and writes its block of the ring, the conv's output is
    gathered over its channel dims, each rank steps the recurrence on its
    heads and writes its block of the state, and the heads' outputs are
    gathered for the gated norm over the whole ``d_inner``."""
    from torch.distributed.tensor import Replicate, Shard

    d_inner, H, conv_dim = ssm_dims(cfg)
    conv, ssm = state["conv"], state["ssm"]
    mesh = conv.device_mesh
    c_roles = B.shard_roles(conv, {0: "rows", 2: "cols"}, all_dims=True)
    s_roles = B.shard_roles(ssm, {0: "rows", 1: "cols"}, all_dims=True)

    def pl(roles, rows, cols):
        return [rows if r == "rows" else cols if r == "cols" else Replicate()
                for r in roles]

    act = pl(c_roles, Shard(0), Replicate())
    zx = zxbcdt.redistribute(mesh, act)
    cc, _ = B.mesh_coord(mesh, [i for i, r in enumerate(c_roles)
                                if r == "cols"])
    sc, _ = B.mesh_coord(mesh, [i for i, r in enumerate(s_roles)
                                if r == "cols"])
    c_loc, h_loc = conv.to_local().shape[-1], ssm.to_local().shape[1]

    def conv_fn(cl, z, w, b):
        xbc, ring = _conv_step(cfg, z, cl, w, b, x.dtype, cc * c_loc)
        cl.copy_(ring)
        return xbc

    xbc = B.local_cache_call(
        conv_fn, (conv,), (zx, p["conv_w"], p["conv_b"]),
        [act, pl(c_roles, Replicate(), Shard(1)),
         pl(c_roles, Replicate(), Shard(0))],
        pl(c_roles, Shard(0), Shard(1)))
    xbc = xbc.redistribute(mesh, act)

    def ssm_fn(hl, xb, z, dt_bias, a_log, d):
        y, h = _ssm_step(cfg, xb, z, hl, dt_bias, a_log, d, sc * h_loc,
                         h_loc)
        hl.copy_(h)
        return y

    heads = pl(s_roles, Replicate(), Shard(0))
    y = B.local_cache_call(
        ssm_fn, (ssm,), (xbc, zx, p["dt_bias"], p["A_log"], p["D"]),
        [act, act, heads, heads, heads], pl(s_roles, Shard(0), Shard(1)))
    y = y.redistribute(mesh, act).reshape(-1, 1, d_inner).to(x.dtype)
    z = _split_proj(cfg, zx)[0]
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return torch.einsum("bse,ed->bsd", y, p["out_proj"].to(x.dtype))
