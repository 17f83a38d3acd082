"""On-device sampling head for the serving engine (port of
``repro.serve.sampling``).

Every knob is a *per-slot* tensor, so one decode tick serves a mixed
population of requests (greedy next to nucleus next to top-k).
Determinism contract: the token sampled for request ``r`` at generation
index ``t`` depends only on ``(r.seed, t)`` and the logits row — never on
which slot the request landed in or who its neighbours are.  The noise is
JAX's own threefry Gumbel draw (:mod:`repro_torch.serve.prng`), so a
sampled stream can be held against the JAX package's.
"""
from __future__ import annotations

import torch

from . import prng


def request_key(seed: int, device=None) -> torch.Tensor:
    """The per-request PRNG base key (``int64 [2]`` of uint32 values)."""
    return prng.prng_key(seed, device)


def token_key(base_key: torch.Tensor, t) -> torch.Tensor:
    """Key for generation index ``t`` of a request (0 = the prefill token);
    ``base_key`` may carry a leading batch, ``t`` one index per key."""
    return prng.fold_in(base_key, t)


def sample_tokens(logits: torch.Tensor, keys: torch.Tensor,
                  temperature: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor) -> torch.Tensor:
    """Sample one token per row; every sampling param is a per-row tensor.

    ``logits`` [B, V] (any float dtype; promoted to f32), ``keys`` [B, 2]
    per-row keys, ``temperature`` [B] (``<= 0`` means greedy argmax),
    ``top_k`` [B] (``<= 0`` disables), ``top_p`` [B] in ``(0, 1]`` (``1``
    disables).  Filters compose as in JAX: temperature scale -> top-k at the
    k-th value -> top-p renormalised nucleus -> Gumbel-max draw.  Returns
    int32 [B].
    """
    logits = logits.float()
    V = logits.shape[-1]
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)

    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    # top-k: keep each row's k largest entries (threshold at the k-th value)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.where(top_k > 0, top_k, V).long()
    kth = torch.gather(sorted_desc, 1, torch.clamp(k - 1, 0, V - 1)[:, None])
    neg_inf = torch.tensor(-torch.inf, device=logits.device)
    masked = torch.where(scaled < kth, neg_inf, scaled)
    # top-p: smallest prefix of the sorted distribution with mass >= p
    probs = torch.softmax(masked, dim=-1)
    probs_desc = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(probs_desc, dim=-1)
    include = (csum - probs_desc) < top_p[:, None]   # always keeps the head
    thr = torch.where(include, probs_desc, torch.inf).amin(dim=-1,
                                                           keepdim=True)
    masked = torch.where(probs < thr, neg_inf, masked)

    sampled = torch.argmax(masked + prng.gumbel(keys, V), dim=-1)
    return torch.where(temperature <= 0.0, greedy_tok, sampled.to(torch.int32))
