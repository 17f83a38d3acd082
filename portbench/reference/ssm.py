"""Plain PyTorch reference of the attention-free Mamba2 language model
(``arch_type: ssm``), from the architecture's equations, not from the
program: each layer a pre-norm residual around the Mamba2 mixer (RMSNorm,
in_proj, the causal depthwise conv and SiLU, dt = softplus(dt + dt_bias),
the SSD scan as the chunked dual form of h_t = exp(dt·A) h_{t-1} +
dt·B_t x_tᵀ, y_t = C_t h_t + D x_t, the gated RMSNorm over d_inner,
out_proj).  Every matrix product goes through ``mm``; each layer is
recomputed in the backward (``torch.utils.checkpoint``).
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .lm import Mm, rmsnorm, softplus
from .params import Spec, lm_specs, n_params, normal


def ssm_dims(arch) -> Tuple[int, int, int, int]:
    """(d_inner, heads, conv channels, in_proj width) of a Mamba2 layer."""
    s = arch["ssm"]
    d_inner = s["expand"] * arch["d_model"]
    heads = d_inner // s["head_dim"]
    gn = s["n_groups"] * s["d_state"]
    conv_dim = d_inner + 2 * gn
    return d_inner, heads, conv_dim, 2 * d_inner + 2 * gn + heads


def param_specs(arch) -> List[Spec]:
    D, s, L = arch["d_model"], arch["ssm"], arch["n_layers"]
    d_inner, H, conv_dim, proj = ssm_dims(arch)
    blk = ("ssm_blocks",)
    return lm_specs(arch) + [
        (blk + ("norm", "scale"), (L, D), ("ones",)),
        (blk + ("ssm", "in_proj"), (L, D, proj), normal(D)),
        (blk + ("ssm", "conv_w"), (L, s["d_conv"], conv_dim),
         normal(s["d_conv"])),
        (blk + ("ssm", "conv_b"), (L, conv_dim), ("zeros",)),
        (blk + ("ssm", "A_log"), (L, H), ("a_log", 1.0, 16.0)),
        (blk + ("ssm", "D"), (L, H), ("ones",)),
        (blk + ("ssm", "dt_bias"), (L, H), ("dt_bias", 1e-3, 0.1)),
        (blk + ("ssm", "norm"), (L, d_inner), ("ones",)),
        (blk + ("ssm", "out_proj"), (L, d_inner, D), normal(d_inner)),
    ]


def stacks(arch):
    """The leaves held stacked ``[L, ...]``, with their L."""
    return {"ssm_blocks": arch["n_layers"]}


def flops_per_token(arch, seq_len: int) -> float:
    """6·N (forward and backward, a multiply-add counting 2), N every
    parameter once: a tied head is the embedding's one application as a
    product (the lookup is none).  The SSD scan's own products are not
    counted, nor the recomputation."""
    return 6.0 * n_params(arch)


def body(arch, tree, x, mm: Mm):
    """The layers over the embedded rows x [b, S, d]."""
    eps = arch["norm_eps"]

    def layer(x, lp):
        return x + mamba2_mixer(arch, lp["ssm"], rmsnorm(
            x, lp["norm"]["scale"], eps), mm)

    for lp in tree["ssm_blocks"]:
        x = checkpoint(layer, x, lp, use_reentrant=False)
    return x


def ssd(x, dt, A, Bm, Cm, Dskip, chunk):
    """The SSD scan from a zero state.  x [b,S,H,P], dt [b,S,H], A [H],
    Bm/Cm [b,S,G,N], Dskip [H] -> y [b,S,H,P]."""
    b, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep, Q = H // G, chunk
    nc = S // Q
    x = x.reshape(b, nc, Q, H, P)
    dt = dt.reshape(b, nc, Q, H)
    Bh = Bm.reshape(b, nc, Q, G, N).repeat_interleave(rep, dim=3)
    Ch = Cm.reshape(b, nc, Q, G, N).repeat_interleave(rep, dim=3)
    cs = torch.cumsum(dt * A, dim=2)                          # [b,c,Q,H]
    tri = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=x.device))
    rel = cs[:, :, :, None, :] - cs[:, :, None, :, :]           # [b,c,i,j,H]
    decay = torch.exp(torch.where(tri[None, None, :, :, None], rel,
                                  torch.full((), -math.inf, device=x.device)))
    cb = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh)
    y = torch.einsum("bcijh,bcjhp->bcihp", cb * decay * dt[:, :, None], x)
    # each chunk's own state, then the states entering each chunk
    w = torch.exp(cs[:, :, -1:, :] - cs) * dt                  # [b,c,Q,H]
    states = torch.einsum("bcjhn,bcjhp->bchpn", Bh * w[..., None], x)
    ccs = torch.cumsum(cs[:, :, -1, :], dim=1)                  # [b,c,H]
    excl = ccs - cs[:, :, -1, :]                                # through c-1
    lower = torch.tril(torch.ones(nc, nc, dtype=torch.bool, device=x.device),
                       diagonal=-1)
    wc = torch.exp(torch.where(lower[None, :, :, None],
                               excl[:, :, None, :] - ccs[:, None, :, :],
                               torch.full((), -math.inf, device=x.device)))
    h_in = torch.einsum("bxyh,byhpn->bxhpn", wc, states)
    y = y + torch.einsum("bcihn,bchpn->bcihp", Ch * torch.exp(cs)[..., None],
                         h_in)
    y = y + Dskip[:, None] * x
    return y.reshape(b, S, H, P)


def mamba2_mixer(arch, p, x, mm: Mm):
    s = arch["ssm"]
    d_inner, H, conv_dim, _ = ssm_dims(arch)
    gn = s["n_groups"] * s["d_state"]
    zxbcdt = mm("bsd,de->bse", x, p["in_proj"])
    z, xbc, dt = torch.split(zxbcdt, [d_inner, conv_dim, H], dim=-1)
    W = s["d_conv"]
    xp = F.pad(xbc, (0, 0, W - 1, 0))
    conv = p["conv_b"] + sum(xp[:, i:i + xbc.shape[1]] * p["conv_w"][i]
                             for i in range(W))
    xbc = F.silu(conv)
    xs, Bm, Cm = torch.split(xbc, [d_inner, gn, gn], dim=-1)
    b, S = x.shape[:2]
    y = ssd(xs.reshape(b, S, H, s["head_dim"]),
            softplus(dt + p["dt_bias"]), -torch.exp(p["A_log"]),
            Bm.reshape(b, S, s["n_groups"], s["d_state"]),
            Cm.reshape(b, S, s["n_groups"], s["d_state"]), p["D"],
            min(s["chunk"], S))
    y = rmsnorm(y.reshape(b, S, d_inner) * F.silu(z), p["norm"],
                arch["norm_eps"])
    return mm("bse,ed->bsd", y, p["out_proj"])


