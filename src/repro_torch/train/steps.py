"""Serving step functions (port of the serving half of ``repro.train.steps``).

JAX jits these and donates the cache and slot state; PyTorch runs them
eagerly and updates both in place.  Train steps come with the training
slice; the sampling head (temperature, top-k, top-p) with the sampling
slice, so this slice builds greedy steps only.
"""
from __future__ import annotations

import torch


def make_serve_step(model):
    """One decode iteration: next-token logits -> greedy token, cache."""

    def serve_step(params, cache, tokens, positions):
        logits, new_cache = model.decode_step(params, cache, tokens, positions)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, new_cache

    return serve_step


def make_engine_step(model, greedy: bool = True, paged: bool = False):
    """The continuous-batching decode tick over the whole slot pool.

    ``slots`` is a dict of per-slot tensors (``n_slots`` leading dim):
    ``tokens`` (last sampled token, fed to this tick), ``pos`` (its absolute
    position), ``active``, ``n_gen`` (tokens generated so far, the prefill
    token counts), ``max_gen`` (budget) and ``eos`` (-1 disables).

    Returns ``(cache, slots, sampled, finished)``.  Cache and slots are
    updated in place (JAX donated them).  Inactive slots keep their token and
    position frozen; their sampled entry is one the scheduler never reads.
    """
    if not greedy:
        raise NotImplementedError(
            "sampled decoding (temperature/top-k/top-p) comes with the "
            "sampling slice of the port; build greedy=True")
    if paged:
        raise NotImplementedError(
            "the paged-cache tick comes with the paged-engine slice of the "
            "port; build paged=False")

    def engine_step(params, cache, slots):
        logits, cache = model.decode_step(params, cache, slots["tokens"],
                                          slots["pos"])
        sampled = torch.argmax(logits, dim=-1).to(torch.int32)
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

    return engine_step
