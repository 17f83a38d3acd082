"""Step functions: train, prefill, serve and the engine tick (port of
``repro.train.steps``).

JAX jits these and donates the state; PyTorch runs them eagerly.  The train
step returns a new state (params and optimizer state are new tensors); the
serving steps update the cache and slot state in place.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..models.base import is_dtensor
from ..models.common import sharded_cross_entropy
from ..tree import tree_leaves, tree_map, tree_select, tree_unflatten


def compute_loss(model, params, batch, mesh_ctx=None, storage_axes=(),
                 mtp_coef: float = 0.3):
    """(total loss, {"ce", **aux}) of one batch; ``total`` adds the router
    balance loss, which is zero for the dense and ssm archs, and
    ``mtp_coef`` times the MTP head's loss where the model has one.  A VLM
    arch's first ``n_patches`` logits (the patch prefix) take no loss.
    Under a mesh (``mesh_ctx``) the forward runs on the plan's DTensors."""
    if mesh_ctx is None:
        logits, aux = model.apply(params, batch)
    else:
        logits, aux = model.apply(params, batch, mesh_ctx, storage_axes)
    if model.cfg.n_patches:
        logits = logits[:, model.cfg.n_patches:]
    loss = sharded_cross_entropy(logits, batch["labels"],
                                 batch.get("loss_mask"))
    total = loss
    if "router_lb" in aux:
        total = total + aux["router_lb"]
    if "mtp" in aux:
        total = total + mtp_coef * aux["mtp"]
    return total, {"ce": loss, **aux}


def microbatch(batch: Dict[str, Any], n_micro: int):
    """``[B, ...]`` leaves -> ``n_micro`` batches of ``[B/n_micro, ...]``,
    contiguous along the batch (``repro.sharding.pipeline.microbatch``'s
    reshape to ``[M, B/M, ...]``, then its M rows)."""
    def split(a):
        bsz = a.shape[0]
        if bsz % n_micro:
            raise ValueError(f"batch {bsz} not divisible by {n_micro} "
                             f"microbatches")
        return a.reshape((n_micro, bsz // n_micro) + tuple(a.shape[1:]))

    mbs = tree_map(split, batch)
    return [tree_map(lambda a, i=i: a[i], mbs) for i in range(n_micro)]


def value_and_grad(loss_fn, params, *args, trainable=None):
    """``(aux, grads)`` of ``loss_fn(params, *args) -> (total, aux)``, the
    aux tensors detached.  Gradients come from ``torch.autograd.grad`` over
    the param leaves; with a ``trainable`` path predicate over those only
    (the others take no gradient, and ``grads`` holds the trainable subtree
    alone — what ``FrozenBaseOptimizer`` updates)."""
    leaves = [p.detach() for p in tree_leaves(params)]
    tree = tree_unflatten(params, leaves)
    wrt = tree if trainable is None else tree_select(tree, trainable)
    for leaf in tree_leaves(wrt):
        leaf.requires_grad_(True)
    total, aux = loss_fn(tree, *args)
    grads = torch.autograd.grad(total, tree_leaves(wrt), allow_unused=True,
                                materialize_grads=True)
    return ({k: v.detach() for k, v in aux.items()},
            tree_unflatten(wrt, grads))


def make_train_step(model, optimizer, mesh_ctx=None, storage_axes=(),
                    grad_accum: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    Gradients come from :func:`value_and_grad` over the param leaves, or
    over those the optimizer's ``trainable`` predicate accepts where it has
    one (``FrozenBaseOptimizer``: the frozen base takes no gradient, as
    JAX's zeroed one moves nothing).  With
    ``grad_accum > 1`` the batch is split into contiguous microbatches, the
    gradients are summed in a carry of at least f32 (also for bf16 params,
    as JAX's ``:60-76``: a bf16 carry would round every micro-step) and the
    gradients and metrics averaged.  Metrics stay 0-d tensors on the device,
    keyed in JAX's (sorted) order: ``ce``, ``loss``, ``mtp`` (with an MTP
    head) and ``router_lb``.

    Unlike JAX's pure step, the step updates ``state`` in place: the
    optimizer writes the params and its state leaf by leaf (see
    ``AdamW.update``), so the returned state holds the same tensors and the
    caller's ``state["params"]`` and ``state["opt"]`` hold the new values.

    Under a mesh (``mesh_ctx``, with the state and the batch laid out as
    DTensors by a sharding plan) the same step runs on DTensors, where
    DTensor's op propagation stands for XLA's GSPMD: each gradient is laid
    out like its param before the update (the data-parallel all-reduce or
    the FSDP reduce-scatter), and the metrics come back as plain
    replicated 0-d tensors.  Under a plan with a pipe axis the backbone
    runs the GPipe schedule (``sharding.pipeline``), each ``grad_accum``
    chunk pipelined; a leaf the pipe axis replicates takes its gradient on
    the stages that use it (the embedding on stage 0), as a partial sum over
    the pipe axis that the redistribution to the leaf's layout reduces, so
    every rank updates it alike.  A context with ``pp > 1`` and no mesh runs
    every stage on this device.  LoRA under a plan is ROADMAP A8b and raises
    here.
    """

    trainable = getattr(optimizer, "trainable", None)
    if mesh_ctx is not None:
        _refuse_a8b(model, trainable, mesh_ctx)

    def loss_fn(params, batch):
        return compute_loss(model, params, batch, mesh_ctx, storage_axes)

    def train_step(state, batch):
        if grad_accum > 1:
            gsum = msum = None
            for mb in microbatch(batch, grad_accum):
                metrics, grads = value_and_grad(loss_fn, state["params"], mb,
                                                trainable=trainable)
                if gsum is None:
                    gsum = tree_map(lambda g: g.to(torch.promote_types(
                        g.dtype, torch.float32)), grads)
                    msum = metrics
                else:
                    gsum = tree_map(torch.add, gsum, grads)
                    msum = tree_map(torch.add, msum, metrics)
            grads = tree_map(lambda g: g / grad_accum, gsum)
            metrics = tree_map(lambda m: m / grad_accum, msum)
        else:
            metrics, grads = value_and_grad(loss_fn, state["params"], batch,
                                            trainable=trainable)
        if mesh_ctx is not None and mesh_ctx.mesh is not None:
            grads = tree_map(lambda g, p: g.redistribute(p.device_mesh,
                                                         p.placements),
                             grads, state["params"])
            metrics = {k: v.full_tensor() if is_dtensor(v) else v
                       for k, v in metrics.items()}
        new_params, new_opt = optimizer.update(grads, state["opt"],
                                               state["params"])
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        metrics = dict(metrics)
        metrics["loss"] = metrics["ce"]
        # sorted by key, as JAX's jitted step returns its dict: the logged
        # rows (history, telemetry) keep JAX's column order
        return new_state, dict(sorted(metrics.items()))

    return train_step


def _refuse_a8b(model, trainable, mesh_ctx) -> None:
    """What a mesh does not train yet: LoRA under a plan, models other than
    the decoder, and the archs ``refuse_mesh`` names."""
    from ..models.transformer import DecoderLM, refuse_mesh
    from ..sharding.plans import A8B

    if trainable is not None:
        raise NotImplementedError(f"LoRA under a plan comes with {A8B}")
    if not isinstance(model, DecoderLM):
        raise NotImplementedError(
            f"{type(model).__name__} under a mesh comes with {A8B}")
    refuse_mesh(model.cfg)


def opt_state_shardings(opt_shapes, pspecs, rep):
    """Shardings for the optimizer state: moment/master trees mirror the
    param tree; scalars replicated."""
    out = {}
    for k, v in opt_shapes.items():
        out[k] = pspecs if isinstance(v, dict) or k in ("m", "v", "master") else rep
    return out


def init_train_state(model, optimizer, gen: torch.Generator, param_dtype=None):
    """Seeded params on ``gen.device`` (f32 leaves cast to ``param_dtype``
    when given), the optimizer's state and a step counter on the device."""
    params = model.init(gen)
    if param_dtype is not None:
        params = tree_map(lambda p: p.to(param_dtype)
                          if p.dtype == torch.float32 else p, params)
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=gen.device)}


def make_prefill_step(model, mesh_ctx=None, storage_axes=()):
    """``prefill_step(params, batch) -> (last-token logits, cache)``: the
    model's prefill, under a mesh on the plan's DTensors (what a dryrun
    traces for a prefill shape)."""

    def prefill_step(params, batch):
        return model.prefill(params, batch, mesh_ctx=mesh_ctx,
                             storage_axes=storage_axes)

    return prefill_step


def make_serve_step(model, mesh_ctx=None):
    """One decode iteration: next-token logits -> greedy token, cache.
    Under a mesh (``mesh_ctx``) on the plan's DTensors, the cache laid out
    by ``plans.cache_shardings`` (what a dryrun traces for a decode shape);
    the greedy token is drawn from the gathered logits
    (:func:`full_logits`)."""

    def serve_step(params, cache, tokens, positions):
        logits, new_cache = model.decode_step(params, cache, tokens, positions,
                                              mesh_ctx)
        next_tok = torch.argmax(full_logits(logits), dim=-1).to(torch.int32)
        return next_tok, logits, new_cache

    return serve_step


def full_logits(logits):
    """The whole logits on every rank: a DTensor (under a mesh the vocab
    dim lies over ``model`` and the slots over the dp axes) gathered once,
    so the sampling head sees what it sees with no mesh."""
    from ..models.base import is_dtensor

    return logits.full_tensor() if is_dtensor(logits) else logits


def make_engine_step(model, mesh_ctx=None, greedy: bool = False,
                     paged: bool = False):
    """The continuous-batching decode tick over the whole slot pool.

    Decode every slot at its own position, run the sampling head (greedy /
    temperature / top-k / top-p, seeded per request) and update the
    per-slot stop flags.  ``slots`` is a dict of per-slot tensors
    (``n_slots`` leading dim):

    - ``tokens`` i32: last sampled token (fed to this tick's decode)
    - ``pos`` i32: absolute position ``tokens`` is written/attended at
    - ``active`` bool: slot holds a live request
    - ``n_gen`` i32: tokens generated so far (the prefill token counts)
    - ``max_gen`` i32: per-request generation budget
    - ``eos`` i32: per-request stop token (-1 disables)
    - ``key`` i64[2]: per-request PRNG base key (token t uses fold_in(key, t))
    - ``temperature``/``top_k``/``top_p``: sampling knobs per slot

    Returns ``(cache, slots, sampled, finished)``.  Cache and slots are
    updated in place (JAX donated them).  Inactive slots keep their token
    and position frozen; their sampled entry is one the scheduler never
    reads.

    ``greedy=True`` builds a sampler-free tick (plain argmax — what
    ``sample_tokens`` returns for ``temperature <= 0``, without the
    full-vocabulary sorts and the noise).  The variant is fixed per engine,
    as in JAX, so one determinism comparison never mixes the two.

    ``paged=True`` builds the tick against a block-pool cache: it takes the
    per-slot page tables as a fourth argument and suppresses the cache
    writes of inactive slots — a retired slot's blocks may already be freed
    and remapped, so its frozen-position write must not land there.

    Under a mesh (``mesh_ctx``) the decode runs on the plan's DTensors and
    each rank's block of the cache; the slot state and the page tables
    stay plain tensors, the same on every rank, and the logits are
    gathered (:func:`full_logits`) before the head, so every rank draws
    the same tokens.
    """
    from ..serve.sampling import sample_tokens, token_key

    def _sample_and_advance(slots, logits, cache):
        logits = full_logits(logits)
        if greedy:
            sampled = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            step_keys = token_key(slots["key"], slots["n_gen"])
            sampled = sample_tokens(logits, step_keys, slots["temperature"],
                                    slots["top_k"], slots["top_p"])
        active = slots["active"]
        live = active.to(torch.int32)
        sampled = torch.where(active, sampled, slots["tokens"])
        n_gen = slots["n_gen"] + live
        finished = active & ((sampled == slots["eos"])
                             | (n_gen >= slots["max_gen"]))
        slots["tokens"].copy_(sampled)
        slots["pos"].add_(live)
        slots["n_gen"].copy_(n_gen)
        slots["active"].copy_(active & ~finished)
        return cache, slots, sampled, finished

    if paged:
        def engine_step(params, cache, slots, pages):
            logits, cache = model.decode_step(
                params, cache, slots["tokens"], slots["pos"], mesh_ctx,
                pages=pages, active=slots["active"])
            return _sample_and_advance(slots, logits, cache)
    else:
        def engine_step(params, cache, slots):
            logits, cache = model.decode_step(params, cache, slots["tokens"],
                                              slots["pos"], mesh_ctx)
            return _sample_and_advance(slots, logits, cache)

    return engine_step


def make_prefill_chunk_step(model, mesh_ctx=None):
    """One fixed-shape chunk of a paged admission (``model.prefill_chunk``).

    The chunk program's shapes depend only on (chunk length, pool shape) —
    never on the prompt length — which is what makes a cached page's values
    bitwise canonical and a long admission splittable across decode ticks.
    The cache is updated in place."""

    def chunk_step(params, cache, pages_row, tokens, start, n_valid):
        return model.prefill_chunk(params, cache, pages_row, tokens, start,
                                   n_valid, mesh_ctx=mesh_ctx)

    return chunk_step
