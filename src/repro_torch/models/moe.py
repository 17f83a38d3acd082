"""Mixture-of-Experts: shared experts + routed experts (top-k)
(port of ``repro.models.moe``).

Routing is JAX's: f32 router logits, softmax, top-k, renormalize
(deepseek-style), and the Switch load-balance loss on the full router
distribution times ``router_aux_coef``.

Two compute paths of the routed experts, the same function:

* ``moe_dense`` — every expert over every token, gate-weighted: JAX's
  oracle path, O(E·T) expert FLOPs.  The plain version: the tests and
  ``chip_smoke.py`` hold the main path against it.
* ``moe_routed`` — the main path, dropless over the selected experts only
  (T·k expert rows where ``moe_dense`` runs T·E: 64/6 ≈ 10.7× fewer expert
  FLOPs for DeepSeekMoE-16B).  It does not call ``moe_dense`` because at
  full width that one would compute and then discard the outputs of the 58
  of 64 experts a token does not use.  Its products are ``torch.matmul``,
  as JAX's are einsums outside any Pallas kernel.

JAX's expert-parallel path (``moe_ep``, ``shard_map`` over a mesh) comes
with ROADMAP A8b.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from . import base as B
from .common import dense_init


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def init_moe(cfg: B.ArchConfig, gen: torch.Generator, lead=()) -> Dict[str, Any]:
    """JAX's tree: ``router [D, E]``, ``w_gate``/``w_up [E, D, F]``,
    ``w_down [E, F, D]`` and, with shared experts, ``shared`` of width
    ``n_shared·F``; ``lead`` prepends stacked dims."""
    m = cfg.moe
    D, E, F_ = cfg.d_model, m.n_routed, m.d_expert
    lead = tuple(lead)
    p = {
        "router": dense_init(gen, lead + (D, E), D),
        "w_gate": dense_init(gen, lead + (E, D, F_), D),
        "w_up": dense_init(gen, lead + (E, D, F_), D),
        "w_down": dense_init(gen, lead + (E, F_, D), F_),
    }
    if m.n_shared:
        Fs = m.n_shared * F_
        p["shared"] = {
            "w_gate": dense_init(gen, lead + (D, Fs), D),
            "w_up": dense_init(gen, lead + (D, Fs), D),
            "w_down": dense_init(gen, lead + (Fs, D), Fs),
        }
    return p


def moe_axes(cfg: B.ArchConfig) -> Dict[str, Any]:
    p = {
        "router": (B.D_MODEL, None),
        "w_gate": (B.EXPERTS, B.D_MODEL, B.D_EXPERT),
        "w_up": (B.EXPERTS, B.D_MODEL, B.D_EXPERT),
        "w_down": (B.EXPERTS, B.D_EXPERT, B.D_MODEL),
    }
    if cfg.moe.n_shared:
        p["shared"] = {
            "w_gate": (B.D_MODEL, B.D_FF),
            "w_up": (B.D_MODEL, B.D_FF),
            "w_down": (B.D_FF, B.D_MODEL),
        }
    return p


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------
def route(cfg: B.ArchConfig, router_w, x_flat):
    """x_flat [T, D] -> (topk_idx [T, k], topk_gate [T, k], aux_loss scalar).

    The gates carry the router's gradient (``topk``'s values are
    differentiable, its indices are not), and so does the balance loss
    through the mean router probabilities."""
    m = cfg.moe
    logits = torch.einsum("td,de->te", x_flat.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, m.top_k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # load-balance loss (Switch-style): E * sum_e f_e * P_e
    E = m.n_routed
    f = torch.bincount(idx.reshape(-1), minlength=E).float() / idx.shape[0]
    pmean = probs.mean(0)
    aux = E * torch.sum(f * pmean) * m.router_aux_coef
    return idx, gate, aux


# ---------------------------------------------------------------------------
# the plain version: every expert over every token
# ---------------------------------------------------------------------------
def moe_dense(cfg: B.ArchConfig, p, x_flat, idx, gate):
    """All experts over all tokens; gate-weighted combine (JAX's oracle)."""
    dt = x_flat.dtype
    h = (F.silu(torch.einsum("td,edf->tef", x_flat, p["w_gate"].to(dt)))
         * torch.einsum("td,edf->tef", x_flat, p["w_up"].to(dt)))
    outs = torch.einsum("tef,efd->ted", h, p["w_down"].to(dt))     # [T, E, D]
    onehot = F.one_hot(idx, cfg.moe.n_routed).to(dt)               # [T, k, E]
    comb = torch.einsum("tk,tke->te", gate.to(dt), onehot)
    return torch.einsum("te,ted->td", comb, outs)


# ---------------------------------------------------------------------------
# the main path: the selected experts only
# ---------------------------------------------------------------------------
def _combine(ys, gate, dt):
    """ys [T, k, D] (expert outputs in the activations' dtype), gate
    [T, k] -> [T, D]: gates rounded to ``dt`` as ``moe_dense``'s ``comb``,
    products summed in f32 and rounded once, as its last einsum.  A sum over
    the k axis, not ``index_add_``, whose atomics on the card would add in
    another order every run."""
    g = gate.to(dt).float()
    return torch.einsum("tk,tkd->td", g, ys.float()).to(dt)


def _gathered(p, x_flat, idx):
    """Each of the T·k assignments through its own expert's weights,
    gathered per assignment: one batched product of T·k rows of one, so a
    row's numbers depend on nothing but its own token and expert (the
    engine's decode tick gives the same stream alone or beside other
    slots), and no count leaves the card."""
    T, k = idx.shape
    dt = x_flat.dtype
    e = idx.reshape(-1)
    xs = x_flat.repeat_interleave(k, dim=0)[:, None]               # [Tk, 1, D]
    h = (F.silu(torch.bmm(xs, p["w_gate"][e].to(dt)))
         * torch.bmm(xs, p["w_up"][e].to(dt)))
    return torch.bmm(h, p["w_down"][e].to(dt)).reshape(T, k, -1)


def _grouped(p, x_flat, idx):
    """The T·k assignments sorted by expert, each expert's rows through its
    three products, the outputs put back in assignment order.  The row
    counts go to the host once (a sync per call) to cut the groups.  The
    stacked weights are split with ``unbind``, whose backward stacks the E
    expert gradients into one tensor (indexing each expert would allocate a
    full-size gradient per expert)."""
    T, k = idx.shape
    dt = x_flat.dtype
    e = idx.reshape(-1)
    order = torch.argsort(e, stable=True)
    xs = x_flat[order // k]                                        # [Tk, D]
    counts = torch.bincount(e).tolist()
    wg, wu, wd = (p[n].unbind(0) for n in ("w_gate", "w_up", "w_down"))
    outs, start = [], 0
    for ex, n in enumerate(counts):
        if n == 0:
            continue
        xe = xs[start:start + n]
        h = F.silu(xe @ wg[ex].to(dt)) * (xe @ wu[ex].to(dt))
        outs.append(h @ wd[ex].to(dt))
        start += n
    ys = torch.empty_like(xs).index_copy(0, order, torch.cat(outs))
    return ys.reshape(T, k, -1)


def moe_routed(cfg: B.ArchConfig, p, x_flat, idx, gate):
    """The routed experts over the selected (token, expert) pairs only:
    ``moe_dense``'s function without its (E - k)/E discarded work.  When
    the T·k assignments are no more than the E experts (a decode tick:
    8 slots × 6 = 48 of 64), each assignment gathers its expert's weights,
    no more expert weights than ``moe_dense`` reads; above that (prefill,
    training) the assignments are grouped by expert."""
    T, k = idx.shape
    if T * k <= cfg.moe.n_routed:
        ys = _gathered(p, x_flat, idx)
    else:
        ys = _grouped(p, x_flat, idx)
    return _combine(ys, gate, x_flat.dtype)


# ---------------------------------------------------------------------------
# full layer
# ---------------------------------------------------------------------------
def moe_forward(cfg: B.ArchConfig, p, x, mesh=None) -> Tuple[torch.Tensor,
                                                             torch.Tensor]:
    """x [B, S, D] -> (out [B, S, D], aux_loss): routed + shared experts."""
    if mesh is not None:
        from ..sharding.plans import A8B

        raise NotImplementedError(
            f"expert parallelism (moe_ep over a mesh) comes with {A8B}")
    Bq, S, D = x.shape
    x_flat = x.reshape(Bq * S, D)
    idx, gate, aux = route(cfg, p["router"], x_flat)
    out = moe_routed(cfg, p, x_flat, idx, gate).reshape(Bq, S, D)
    if cfg.moe.n_shared:
        s = p["shared"]
        h = (F.silu(torch.einsum("bsd,df->bsf", x, s["w_gate"].to(x.dtype)))
             * torch.einsum("bsd,df->bsf", x, s["w_up"].to(x.dtype)))
        out = out + torch.einsum("bsf,fd->bsd", h, s["w_down"].to(x.dtype))
    return out, aux
