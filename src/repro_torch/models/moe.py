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

* ``moe_ep`` — expert parallelism under a mesh (JAX's ``shard_map`` body,
  ``_ep_local``, run through ``base.local_call``): each rank's experts over
  the assignments routed to them, up to a fixed capacity per expert, the
  partial sums reduced by DTensor.

The balance loss is formed from per-layer sums (``route_stats``), so a
batch cut into microbatches or across ranks gives the whole batch's loss.
"""
from __future__ import annotations

import functools
import math
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
def route_stats(cfg: B.ArchConfig, router_w, x_flat):
    """x_flat [T, D] -> (topk_idx [T, k], topk_gate [T, k], stats [2, E]):
    ``stats[0]`` counts the assignments each expert takes, ``stats[1]`` sums
    each expert's router probability over the T tokens (f32), the sums the
    Switch balance loss reads (:func:`balance_loss`).  Sums over tokens, so
    the statistics of several microbatches or ranks add up to the whole
    batch's.

    The gates carry the router's gradient (``topk``'s values are
    differentiable, its indices are not), and so does ``stats[1]``."""
    m = cfg.moe
    logits = torch.einsum("td,de->te", x_flat.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, m.top_k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    counts = torch.zeros(m.n_routed, dtype=torch.float32,
                         device=x_flat.device).index_add_(
        0, idx.reshape(-1), torch.ones(idx.numel(), device=x_flat.device))
    return idx, gate, torch.stack([counts, probs.sum(0)])


def balance_loss(cfg: B.ArchConfig, stats, n_tokens: int):
    """The Switch load-balance loss of one layer, ``E * sum_e f_e * P_e``
    times ``router_aux_coef``, from the statistics of all ``n_tokens``
    tokens (JAX's ``route``: ``f`` the assignments per token, ``P`` the mean
    router probability)."""
    m = cfg.moe
    f = stats[0] / n_tokens
    pmean = stats[1] / n_tokens
    return m.n_routed * torch.sum(f * pmean) * m.router_aux_coef


def route(cfg: B.ArchConfig, router_w, x_flat):
    """x_flat [T, D] -> (topk_idx [T, k], topk_gate [T, k], aux_loss scalar)
    (JAX's ``route``): :func:`route_stats` and the balance loss of its T
    tokens."""
    idx, gate, stats = route_stats(cfg, router_w, x_flat)
    return idx, gate, balance_loss(cfg, stats, x_flat.shape[0])


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
    counts go to the host once (a sync per call) to cut the groups (on
    ``meta`` the rows are cut evenly).  The
    stacked weights are split with ``unbind``, whose backward stacks the E
    expert gradients into one tensor (indexing each expert would allocate a
    full-size gradient per expert)."""
    T, k = idx.shape
    dt = x_flat.dtype
    e = idx.reshape(-1)
    order = torch.argsort(e, stable=True)
    xs = x_flat[order // k]                                        # [Tk, D]
    if e.device.type == "meta":
        # a dryrun has no counts: the T·k rows cut evenly over the experts,
        # the same products and bytes as a balanced batch
        E = p["w_gate"].shape[0]
        counts = [T * k // E + (ex < T * k % E) for ex in range(E)]
    else:
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
# expert parallelism (JAX's ``moe_ep``: ``shard_map`` there, ``local_call``
# here)
# ---------------------------------------------------------------------------
def _capacity(T: int, k: int, ep: int, cf: float) -> int:
    total = T * k
    if total <= 4096:
        return total  # dropless for small token counts (decode)
    c = int(math.ceil(cf * total / ep))
    return min(total, ((c + 127) // 128) * 128)


def capacity_buckets(cfg: B.ArchConfig, idx, e0: int, E_loc: int,
                     ep_size: int):
    """Where each of the T·k assignments of ``idx`` [T, k] goes on the EP
    rank of experts ``[e0, e0 + E_loc)`` (JAX's ``_ep_local``): ``(local,
    keep, bucket, position, C_e)``, ``local`` the assignments to this
    rank's experts, ``keep`` those among them within the first ``C_e`` of
    their expert in row-major order (a running count, JAX's cumsum), each
    kept one's expert bucket and slot; the others go to bucket ``E_loc``,
    slot 0."""
    m = cfg.moe
    T, k = idx.shape
    dev = idx.device
    eids = idx.reshape(-1)
    local = (eids >= e0) & (eids < e0 + E_loc)
    C_total = _capacity(T, k, ep_size, m.capacity_factor)
    C_e = max(8, -(-int(C_total * m.capacity_factor) // E_loc))
    leid = torch.where(local, eids - e0, torch.full_like(eids, E_loc))
    onehot = (leid[:, None] == torch.arange(E_loc + 1, device=dev)).to(
        torch.int32)                                          # [T*k, E+1]
    pos = ((torch.cumsum(onehot, 0) - 1) * onehot).sum(1)     # pos in expert
    keep = local & (pos < C_e)
    bidx = torch.where(keep, leid, torch.full_like(leid, E_loc))
    bpos = torch.where(keep, pos, torch.zeros_like(pos))
    return local, keep, bidx, bpos, C_e


def _ep_local(cfg, x_loc, idx_loc, gate_loc, wg, wu, wd, *, e0: int,
              ep_size: int):
    """One rank's EP body (JAX's ``_ep_local``) on local tensors: x_loc
    [T, D], idx/gate [T, k], w* this rank's ``E_loc = E / ep_size`` experts
    ``[E_loc, D, F]`` / ``[E_loc, F, D]`` starting at expert ``e0``.
    Returns this rank's partial sum [T, D] over its experts.

    The T·k assignments are taken in their row-major order; each local
    expert keeps the first ``C_e`` of its own (a running count, JAX's
    cumsum), the rest are dropped, as JAX drops them.  The kept ones are
    bucketed ``[E_loc, C_e, D]`` and go through the three products as one
    batched matmul each; the outputs are gathered back per assignment and
    combined with the gates as ``moe_routed`` combines them."""
    T, D = x_loc.shape
    k = cfg.moe.top_k
    E_loc = wg.shape[0]
    dev = x_loc.device
    tok = torch.arange(T * k, device=dev) // k
    _, keep, bidx, bpos, C_e = capacity_buckets(cfg, idx_loc, e0, E_loc,
                                                ep_size)
    xs = x_loc[tok] * keep[:, None].to(x_loc.dtype)           # [T*k, D]
    buckets = torch.zeros((E_loc + 1, C_e, D), dtype=x_loc.dtype, device=dev)
    buckets = buckets.index_put((bidx, bpos), xs, accumulate=True)
    xb = buckets[:E_loc]                                      # [E_loc, C_e, D]
    dt = xb.dtype
    h = (F.silu(torch.einsum("ecd,edf->ecf", xb, wg.to(dt)))
         * torch.einsum("ecd,edf->ecf", xb, wu.to(dt)))
    yb = torch.einsum("ecf,efd->ecd", h, wd.to(dt))           # [E_loc, C_e, D]
    ys = yb[torch.where(keep, bidx, torch.zeros_like(bidx)), bpos]
    g = gate_loc.reshape(-1) * keep.to(gate_loc.dtype)
    return _combine(ys.reshape(T, k, D), g.reshape(T, k), dt)


def moe_ep(cfg: B.ArchConfig, p, x_flat, idx, gate, mesh_ctx: B.MeshContext,
           storage_axes: Tuple[str, ...] = ()):
    """The routed experts expert-parallel over ``mesh_ctx.ep_axes`` (JAX's
    ``moe_ep``), through ``base.local_call``: tokens sharded over the dp
    axes that EP leaves free (where they divide; else replicated), experts
    ``Shard(0)`` over the EP axes.  The experts' ``d_model`` dim, stored
    sharded over ``storage_axes``, is all-gathered as the body's input is
    laid out (its backward reduce-scatters the gradient: JAX's all-gather
    inside ``shard_map`` and its transpose).  Each rank returns its partial
    sum ``Partial()`` on the EP dims: DTensor reduces it once where it is
    read, and its backward hands every rank the cotangent once (an
    all-reduce inside whose backward all-reduces again would multiply the
    gradients by the EP degree)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = mesh_ctx.mesh
    names = list(mesh.mesh_dim_names)
    ep_axes = tuple(mesh_ctx.ep_axes)
    ep_size = mesh_ctx.ep_size
    free_dp = tuple(a for a in mesh_ctx.dp_axes if a not in ep_axes)
    dp_ok = bool(free_dp) and x_flat.shape[0] % mesh_ctx.axis_size(free_dp) == 0
    tok_dims = set(free_dp) if dp_ok else set()
    rank = 0
    for ax in ep_axes:
        rank = rank * mesh_ctx.axis_size(ax) + mesh.get_local_rank(ax)
    e0 = rank * (cfg.moe.n_routed // ep_size)

    def pl(tok, ep, other=Replicate()):
        return [tok if n in tok_dims else ep if n in ep_axes else other
                for n in names]

    tokens = pl(Shard(0), Replicate())
    experts = pl(Replicate(), Shard(0))
    fn = functools.partial(_ep_local, cfg, e0=e0, ep_size=ep_size)

    def body(x, i, g, wg, wu, wd):
        return fn(x, i, g, wg, wu, wd)

    return B.local_call(
        body, (x_flat, idx, gate, p["w_gate"], p["w_up"], p["w_down"]),
        in_placements=[tokens] * 3 + [experts] * 3,
        grad_placements=[pl(Shard(0), Partial())] * 3
        + [pl(Partial(), Shard(0))] * 3,
        out_placements=pl(Shard(0), Partial()))


def _route_mesh(cfg, router_w, x_flat, mesh_ctx):
    """``route_stats`` under a mesh, on each rank's tokens (its rows of the
    dp-sharded batch); the statistics come back summed over the whole
    batch, replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    names = list(mesh_ctx.mesh.mesh_dim_names)
    tok = list(x_flat.placements)
    sharded = {n for n, q in zip(names, tok) if isinstance(q, Shard)}
    part = [Partial() if n in sharded else Replicate() for n in names]
    rep = [Replicate()] * len(names)
    idx, gate, stats = B.local_call(
        lambda x, w: route_stats(cfg, w, x), (x_flat, router_w),
        in_placements=[tok, rep], grad_placements=[tok, part],
        out_placements=(tok, tok, part))
    return idx, gate, stats.redistribute(mesh_ctx.mesh, rep)


def _routed_mesh(cfg, p, x_flat, idx, gate):
    """``moe_routed`` under a mesh without EP, on each rank's tokens with
    every expert's weights gathered."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x_flat.device_mesh
    tok = list(x_flat.placements)
    part = [Partial() if isinstance(q, Shard) else Replicate() for q in tok]
    rep = [Replicate()] * mesh.ndim

    def body(x, i, g, wg, wu, wd):
        return moe_routed(cfg, {"w_gate": wg, "w_up": wu, "w_down": wd},
                          x, i, g)

    return B.local_call(
        body, (x_flat, idx, gate, p["w_gate"], p["w_up"], p["w_down"]),
        in_placements=[tok] * 3 + [rep] * 3,
        grad_placements=[tok] * 3 + [part] * 3, out_placements=tok)


def use_ep(cfg: B.ArchConfig, mesh_ctx) -> bool:
    """JAX's condition for the expert-parallel path."""
    return (mesh_ctx is not None and mesh_ctx.mesh is not None
            and mesh_ctx.ep_enabled and mesh_ctx.tp_axis is not None
            and cfg.moe.n_routed % mesh_ctx.ep_size == 0)


# ---------------------------------------------------------------------------
# full layer
# ---------------------------------------------------------------------------
def moe_layer(cfg: B.ArchConfig, p, x, mesh_ctx=None,
              storage_axes: Tuple[str, ...] = ()):
    """x [B, S, D] -> (out [B, S, D], router statistics [2, E] of its B·S
    tokens): routed + shared experts.  Under a mesh (DTensors) the routing
    runs on each rank's tokens and the routed experts through
    :func:`moe_ep` where the plan has EP (JAX's condition), else through
    ``moe_routed`` on each rank's tokens; with no mesh, ``moe_routed``."""
    Bq, S, D = x.shape
    x_flat = x.reshape(Bq * S, D)
    on_mesh = mesh_ctx is not None and mesh_ctx.mesh is not None
    if on_mesh:
        idx, gate, stats = _route_mesh(cfg, p["router"], x_flat, mesh_ctx)
    else:
        idx, gate, stats = route_stats(cfg, p["router"], x_flat)
    if use_ep(cfg, mesh_ctx):
        routed = moe_ep(cfg, p, x_flat, idx, gate, mesh_ctx, storage_axes)
    elif on_mesh:
        routed = _routed_mesh(cfg, p, x_flat, idx, gate)
    else:
        routed = moe_routed(cfg, p, x_flat, idx, gate)
    out = routed.reshape(Bq, S, D)
    if cfg.moe.n_shared:
        s = p["shared"]
        h = (F.silu(torch.einsum("bsd,df->bsf", x, s["w_gate"].to(x.dtype)))
             * torch.einsum("bsd,df->bsf", x, s["w_up"].to(x.dtype)))
        out = out + torch.einsum("bsf,fd->bsd", h, s["w_down"].to(x.dtype))
    return out, stats


def moe_forward(cfg: B.ArchConfig, p, x, mesh_ctx=None,
                storage_axes: Tuple[str, ...] = ()) -> Tuple[torch.Tensor,
                                                             torch.Tensor]:
    """x [B, S, D] -> (out [B, S, D], aux_loss) (JAX's ``moe_forward``):
    :func:`moe_layer` and the balance loss of its tokens."""
    out, stats = moe_layer(cfg, p, x, mesh_ctx, storage_axes)
    return out, balance_loss(cfg, stats, x.shape[0] * x.shape[1])
