"""Pipeline parallelism: the GPipe stage/microbatch schedule (port of
``repro.sharding.pipeline``).

Layers stacked ``[L, ...]`` split into S stages of ``L/S`` layers; M
microbatches go through them in ``S + M - 1`` ticks, stage ``s`` running
microbatch ``t - s`` at tick ``t``, so the schedule idles ``(S-1)/(S+M-1)``
of the time.  :func:`pipeline_apply` (the training path) runs that schedule
in one of two modes:

* **stage-local** (``pipe`` None): every stage runs in this process, on the
  ``[S, L/S, ...]`` view of the stacked params (:func:`stage_split`), and the
  shift between ticks hands each stage's output to the next stage in a
  list.  This is what JAX's function does when the stage dim is not spread
  over devices.
* **pipe-sharded** (a :class:`Pipe`): each rank of the mesh's pipe axis runs
  its own stage, on its local block of the stacked params (under a
  ``pp`` plan, the ``[L/S, ...]`` rows the pipe axis gives it: the staged
  view IS the stored layout, no copy).  The shift is a ring permute over
  the pipe group, an ``all_to_all_single`` with one non-empty split (JAX's
  ``jnp.roll``, which XLA lowers to a collective-permute), differentiable,
  and the last stage's outputs reach every rank through an all-reduce
  whose backward hands each rank its cotangent once.

Both modes compute only the S·M (stage, microbatch) pairs the schedule
fills; JAX's SPMD form also computes masked garbage in the bubble.  The
carry is a dict of tensors (JAX's pytree), so auxiliary state (the MoE
router's per-layer statistics) rides beside the activations.

:func:`gpipe_apply` is JAX's explicit-SPMD engine over the same schedule
(one layer a stage, a tensor carry, the output on every rank).

In the pipe-sharded mode every rank runs every tick's shift, and every
shift's input and output stay in the autograd graph on every rank (an idle
stage passes its input through, stage 0 adds ``0 *`` the buffer it
replaces, the first buffer is ``0 *`` the first microbatch and the final
buffer enters the output as ``0 *`` its sum): so the backward runs the
shifts' transposes in the reverse order on every rank, as a collective
must, and anything that reduces the inputs' gradient over the pipe axis
runs after them on every rank.  Shifted leaves are laid out
like the carry's first microbatch (JAX's ``cst_state``), so every rank
sends blocks of one layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """Idle fraction of the GPipe schedule; 0 for the S=1 degenerate case."""
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if n_stages == 1:
        return 0.0
    if n_micro < 1:
        raise ValueError(f"n_micro must be >= 1, got {n_micro}")
    return (n_stages - 1) / (n_stages + n_micro - 1)


def effective_n_micro(n_micro: int, n_stages: int, global_batch: int = 0) -> int:
    """The microbatch count the schedule actually uses: ``n_micro`` (or the
    ``2 * n_stages`` GPipe default) reduced to the largest divisor of the
    global batch so every microbatch is equal-sized."""
    m = n_micro or 2 * n_stages
    if global_batch:
        m = min(m, global_batch)
        while global_batch % m:
            m -= 1
    return max(m, 1)


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# staging / microbatching views
# ---------------------------------------------------------------------------
def stage_split(tree: Any, n_stages: int) -> Any:
    """``[L, ...]`` leaves -> ``[S, L/S, ...]`` views."""

    def split(a):
        L = a.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers not divisible by {n_stages} stages")
        return a.reshape((n_stages, L // n_stages) + tuple(a.shape[1:]))

    return _map(split, tree)


def microbatch(tree: Any, n_micro: int) -> Any:
    """``[B, ...]`` leaves -> ``[M, B/M, ...]``."""

    def split(a):
        bsz = a.shape[0]
        if bsz % n_micro:
            raise ValueError(
                f"batch {bsz} not divisible by {n_micro} microbatches")
        return a.reshape((n_micro, bsz // n_micro) + tuple(a.shape[1:]))

    return _map(split, tree)


def unmicrobatch(tree: Any) -> Any:
    """Inverse of :func:`microbatch`: ``[M, mb, ...]`` -> ``[B, ...]``."""
    return _map(lambda a: a.reshape((a.shape[0] * a.shape[1],)
                                    + tuple(a.shape[2:])), tree)


# ---------------------------------------------------------------------------
# the pipe axis
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Pipe:
    """This rank's place on a mesh's pipe axis: the axis's process
    ``group``, its ``size`` (the stage count), this rank's ``rank`` (its
    stage) and the axis's name.  ``mesh`` is the whole ``DeviceMesh`` and
    ``stage_mesh`` the submesh of its other dims, where a stage's body runs
    (both None for plain tensors).  ``launch.mesh.pipe_of`` makes one."""

    group: Any
    size: int
    rank: int
    axis: str = "pipe"
    mesh: Any = None
    stage_mesh: Any = None

    @property
    def last(self) -> bool:
        return self.rank == self.size - 1


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _local(t):
    return t.to_local() if _is_dtensor(t) else t


def _rewrap(local, like):
    """``local`` as a block of ``like``'s layout (itself for a plain
    ``like``)."""
    if not _is_dtensor(like):
        return local
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False)


def _on_local(fn, t):
    """``fn`` on ``t``'s local block, rewrapped with ``t``'s layout."""
    return _rewrap(fn(_local(t)), t)


def _shift_bytes(tensors, pipe: Pipe, step: int):
    """``tensors`` from stage ``s`` to stage ``s + step`` (mod S) in ONE
    ``all_to_all_single`` with one non-empty split: their bytes packed into
    one buffer, each at its own width (every piece starts on a 16-byte
    boundary so it views back as its dtype)."""
    import torch.distributed._functional_collectives as fc

    sizes = [t.numel() * t.element_size() for t in tensors]
    spans = [-(-n // 16) * 16 for n in sizes]
    dev = tensors[0].device
    parts = []
    for t, n, span in zip(tensors, sizes, spans):
        parts.append(t.contiguous().reshape(-1).view(torch.uint8))
        if span > n:
            parts.append(torch.zeros(span - n, dtype=torch.uint8, device=dev))
    send = [0] * pipe.size
    recv = [0] * pipe.size
    send[(pipe.rank + step) % pipe.size] = sum(spans)
    recv[(pipe.rank - step) % pipe.size] = sum(spans)
    buf = fc.wait_tensor(fc.all_to_all_single(torch.cat(parts), recv, send,
                                              pipe.group))
    out, start = [], 0
    for t, n, span in zip(tensors, sizes, spans):
        out.append(buf[start:start + n].view(t.dtype).reshape(t.shape))
        start += span
    return tuple(out)


class _Shift(torch.autograd.Function):
    """Stage ``s``'s blocks to stage ``s + 1`` (the last stage's to stage
    0); the backward sends each cotangent back, in one collective too."""

    @staticmethod
    def forward(ctx, pipe, *locs):
        ctx.pipe = pipe
        return _shift_bytes(locs, pipe, 1)

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + _shift_bytes(grads, ctx.pipe, -1)


def _shift_tree(tree, pipe: Pipe):
    """Every leaf of a carry to the next stage in ONE collective (the
    ring's ``all_to_all_single``, :func:`_shift_bytes`), differentiable,
    each leaf at its own width: so the backward's shifts cannot come in
    another order on another stage, whose graph differs, and a bf16 block
    does not cross as f32 beside f32 router statistics."""
    leaves = _leaves(tree)
    shifted = iter(_Shift.apply(pipe, *[_local(a) for a in leaves]))
    return _map(lambda a: _rewrap(next(shifted), a), tree)


class _FromLast(torch.autograd.Function):
    """The sum of every stage's block (the last stage's output, zeros
    elsewhere) on every rank of the pipe group; every rank computes the same
    loss from it, so each rank's cotangent is already the whole one and the
    backward passes it on once (an all-reduce there would count it S
    times)."""

    @staticmethod
    def forward(ctx, local, group):
        import torch.distributed._functional_collectives as fc

        return fc.wait_tensor(fc.all_reduce(local.contiguous(), "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


def _from_last(t, pipe: Pipe):
    return _on_local(lambda local: _FromLast.apply(local, pipe.group), t)


def _layout_like(t, like):
    """``t`` laid out as ``like`` (JAX's ``cst_state``): every rank then
    shifts blocks of one layout."""
    if not _is_dtensor(t) or tuple(t.placements) == tuple(like.placements):
        return t
    return t.redistribute(like.device_mesh, like.placements)


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------
def pipeline_apply(stage_fn: Callable[[Any, Any], Any], staged_params: Any,
                   micro: Any, pipe: Optional[Pipe] = None) -> Any:
    """GPipe: ``micro``'s structure (leaves ``[M, mb, ...]``) with every
    microbatch pushed through all S stages in schedule order.

    ``stage_fn(stage_params, carry) -> carry`` is ONE stage's work on one
    microbatch's carry (a dict of tensors).  With ``pipe`` None (stage-local)
    ``staged_params`` leaves are ``[S, L/S, ...]``; with a :class:`Pipe`
    they are this rank's stage's ``[L/S, ...]`` and the result is on every
    rank of the pipe group.  Differentiable end to end: the backward is the
    pipelined backward, and each stage's gradient sums its microbatches'."""
    leaves = _leaves(micro)
    if not leaves:
        return micro
    n_micro = leaves[0].shape[0]
    if pipe is None:
        n_stages = _leaves(staged_params)[0].shape[0]
        return _pipeline_local(stage_fn, staged_params, micro, n_stages,
                               n_micro)
    return _pipeline_sharded(stage_fn, staged_params, micro, pipe, n_micro)


def _take(tree, i):
    return _map(lambda a: a[i], tree)


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def _pipeline_local(stage_fn, staged, micro, n_stages, n_micro):
    """Every stage here: ``state[s]`` is what stage ``s`` produced at the
    last tick, and the shift hands it to stage ``s + 1``."""
    params = [_take(staged, s) for s in range(n_stages)]
    state = [None] * n_stages
    outs = [None] * n_micro
    for t in range(n_stages + n_micro - 1):
        ins = [_take(micro, t) if t < n_micro else None] + state[:-1]
        for s in range(n_stages):
            m = t - s
            state[s] = (stage_fn(params[s], ins[s]) if 0 <= m < n_micro
                        else None)
        if t >= n_stages - 1:
            outs[t - (n_stages - 1)] = state[-1]
    return _stack(outs)


def _pipeline_sharded(stage_fn, params, micro, pipe, n_micro):
    """This rank's stage: it takes microbatch ``t - rank`` at tick ``t``
    (stage 0 from ``micro``, the others from the ring shift), passes its
    buffer through while idle, and the last stage keeps its outputs."""
    first = _take(micro, 0)
    # the first buffer is 0 * the first microbatch, and takes gradient
    # whenever the schedule does: every rank's first shift is then in the
    # graph (also where an idle stage sends it on unchanged), and the
    # inputs' gradient is complete on every rank only after the last shift
    # of the backward, so what reduces it over the pipe axis runs after the
    # shifts on every rank
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in _leaves(params) + _leaves(micro))

    def zero(a):
        b = 0 * a
        return b.requires_grad_() if grad and not b.requires_grad else b

    buf = _map(zero, first)
    outs = []
    y = buf
    n_ticks = pipe.size + n_micro - 1
    for t in range(n_ticks):
        m = t - pipe.rank
        if pipe.rank == 0 and t < n_micro:
            x_in = _map(lambda a, b: a + 0 * b, _take(micro, t), buf)
        else:
            x_in = buf
        active = 0 <= m < n_micro
        y = stage_fn(params, x_in) if active else x_in
        y = _map(_layout_like, y, first)
        if active and pipe.last:
            outs.append(y)
        if t < n_ticks - 1:
            buf = _shift_tree(y, pipe)
    # the final buffer enters the output with weight 0, so every shift
    # takes part in every rank's backward
    anchor = sum(0 * _local(a).sum() for a in _leaves(y))

    def gather(f, *parts):
        if not pipe.last:
            parts = [torch.zeros_like(f)] * n_micro
        out = _on_local(lambda a: a + anchor.to(a.dtype), torch.stack(parts))
        return _from_last(out, pipe)

    return _map(gather, first, *outs)


# ---------------------------------------------------------------------------
# a pipe axis under a mesh: the batch onto a stage's submesh and back
# ---------------------------------------------------------------------------
def enter(x, n_micro: int, pipe: Optional[Pipe]):
    """``[B, ...]`` -> ``[M, B/M, ...]`` microbatches, in the pipe-sharded
    mode as a DTensor on the stage's submesh.  Each rank cuts its own rows
    into the M microbatches where they divide (no data moves: microbatch
    ``m`` is then the union of every rank's ``m``-th row block, which only
    reorders the batch, and :func:`leave` undoes it); else the batch is
    gathered and cut as JAX cuts it.  The input is replicated over the pipe
    axis but only stage 0 reads it, so its gradient is a partial sum over
    the pipe axis."""
    if pipe is None or not _is_dtensor(x):
        return microbatch(x, n_micro)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    pipe_dim = list(pipe.mesh.mesh_dim_names).index(pipe.axis)
    pl = list(x.placements)
    sharded = any(isinstance(p, Shard) for p in pl)
    local_rows = x.to_local().shape[0]
    if sharded and (any(isinstance(p, Shard) and p.dim != 0 for p in pl)
                    or local_rows % n_micro):
        x = x.redistribute(pipe.mesh, [Replicate()] * len(pl))
        pl = list(x.placements)
    grad_pl = list(pl)
    grad_pl[pipe_dim] = Partial()
    local = x.to_local(grad_placements=grad_pl)
    local = local.reshape((n_micro, local.shape[0] // n_micro)
                          + tuple(local.shape[1:]))
    sub = [Shard(p.dim + 1) if isinstance(p, Shard) else p
           for i, p in enumerate(pl) if i != pipe_dim]
    return DTensor.from_local(local, pipe.stage_mesh, sub, run_check=False)


def leave(x, pipe: Optional[Pipe], merge: bool = True):
    """The inverse of :func:`enter` (``merge`` False: no microbatch dim to
    fold back, the leaf only leaves the submesh): a DTensor on the whole
    mesh, replicated over the pipe axis, as every rank holds it."""
    if pipe is None or not _is_dtensor(x):
        return unmicrobatch(x) if merge else x
    from torch.distributed.tensor import DTensor, Replicate, Shard

    local = x.to_local()
    pl = list(x.placements)
    if merge:
        local = local.reshape((local.shape[0] * local.shape[1],)
                              + tuple(local.shape[2:]))
        pl = [Shard(p.dim - 1) if isinstance(p, Shard) else p for p in pl]
    out, it = [], iter(pl)
    for n in pipe.mesh.mesh_dim_names:
        out.append(Replicate() if n == pipe.axis else next(it))
    return DTensor.from_local(local, pipe.mesh, out, run_check=False)


def local_stage(tree, pipe: Pipe):
    """This rank's stage of stacked params laid out on ``pipe.mesh`` (the
    stacked dim sharded over the pipe axis): its local ``[L/S, ...]``
    block, as a DTensor on the stage's submesh with the leaf's other
    placements.  The gradient goes back to the leaf's own block."""
    from torch.distributed.tensor import DTensor, Shard

    pipe_dim = list(pipe.mesh.mesh_dim_names).index(pipe.axis)

    def one(t):
        pl = list(t.placements)
        if not (isinstance(pl[pipe_dim], Shard) and pl[pipe_dim].dim == 0):
            raise ValueError(
                f"a stacked leaf of shape {tuple(t.shape)} is not staged "
                f"over the pipe axis ({pl})")
        sub = [p for i, p in enumerate(pl) if i != pipe_dim]
        return DTensor.from_local(t.to_local(), pipe.stage_mesh, sub,
                                  run_check=False)

    return _map(one, tree)


# ---------------------------------------------------------------------------
# JAX's explicit-SPMD engine
# ---------------------------------------------------------------------------
def gpipe_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                stage_params: Any, x: torch.Tensor,
                pipe: Optional[Pipe] = None) -> torch.Tensor:
    """Run ``x`` ``[n_micro, micro_batch, ...]`` through the stages with the
    GPipe schedule; returns the last stage's ``[n_micro, micro_batch, ...]``
    outputs (on every rank of the pipe group).

    ``stage_params`` leaves are ``[n_stages, ...]`` (stage-local, ``pipe``
    None) or this rank's ``[1, ...]`` (JAX's ``shard_map`` block over the
    pipe axis)."""
    n_micro = x.shape[0]
    if n_micro < 1:
        raise ValueError("gpipe_apply needs at least one microbatch")

    def one(p, c):
        return {"x": stage_fn(p, c["x"])}

    if pipe is None:
        return pipeline_apply(one, stage_params, {"x": x})["x"]
    params = _take(stage_params, 0)
    return pipeline_apply(one, params, {"x": x}, pipe)["x"]
