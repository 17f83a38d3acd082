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
    returned a new one) and returned."""
    s = cfg.ssm
    d_inner, H, conv_dim = ssm_dims(cfg)
    zxbcdt = torch.einsum("bsd,de->bse", x, p["in_proj"].to(x.dtype))
    z, xs, Bm, Cm, dt = _split_proj(cfg, zxbcdt)
    xBC_new = torch.cat([xs, Bm, Cm], dim=-1)[:, 0]               # [B, conv_dim]
    # conv ring: the state holds the last W-1 inputs
    conv = state["conv"]
    hist = torch.cat([conv, xBC_new[:, None, :].to(conv.dtype)], dim=1)
    w = p["conv_w"].to(x.dtype)                                   # [W, C]
    xBC = torch.einsum("bwc,wc->bc", hist.to(x.dtype), w) \
        + p["conv_b"].to(x.dtype)
    xBC = F.silu(xBC)
    gn = s.n_groups * s.d_state
    xs1, Bm1, Cm1 = torch.split(xBC, [d_inner, gn, gn], dim=-1)
    dt1 = _softplus(dt[:, 0].float() + p["dt_bias"])              # [B,H]
    A = -torch.exp(p["A_log"])
    xs1 = xs1.reshape(-1, H, s.head_dim).float()
    Bm1 = Bm1.reshape(-1, s.n_groups, s.d_state).float()
    Cm1 = Cm1.reshape(-1, s.n_groups, s.d_state).float()
    rep = H // s.n_groups
    Bh = Bm1.repeat_interleave(rep, dim=1)                        # [B,H,N]
    Ch = Cm1.repeat_interleave(rep, dim=1)
    dA = torch.exp(dt1 * A)                                       # [B,H]
    h = state["ssm"] * dA[:, :, None, None] + torch.einsum(
        "bhn,bhp,bh->bhpn", Bh, xs1, dt1)
    y = torch.einsum("bhpn,bhn->bhp", h, Ch) + p["D"][None, :, None] * xs1
    y = y.reshape(-1, 1, d_inner).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(x.dtype))
    conv.copy_(hist[:, 1:])
    state["ssm"].copy_(h)
    return out, state

