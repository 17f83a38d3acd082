"""Synthetic serving workloads: seeded request traces for the engine.

The port's own copy of ``repro.serve.workload`` (it imports nothing of
``repro``).

A trace is a list of :class:`Request` — Poisson arrivals (or all-at-once
when ``rate=0``), prompt/generation lengths drawn from small choice sets
(so the per-prompt-length prefill compiles stay bounded), and per-request
sampling settings + PRNG seeds.  The same seed always produces the same
trace, and a request carries everything needed to replay it alone — the
engine invariant tests regenerate single requests bit-for-bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Request:
    """One inference request, self-contained and replayable."""

    rid: int
    prompt: np.ndarray            # int32 [P] token ids
    max_new: int                  # generation budget (includes prefill token)
    arrival_s: float = 0.0        # offset from trace start
    seed: int = 0                 # per-request sampling PRNG seed
    temperature: float = 0.0      # <= 0 => greedy
    top_k: int = 0                # <= 0 => disabled
    top_p: float = 1.0            # 1.0 => disabled
    eos_id: int = -1              # -1 => never stop on a token
    deadline_s: float = 0.0       # wall budget from arrival; 0 = none

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))


def synthetic_trace(n_requests: int, vocab: int, *, seed: int = 0,
                    rate: float = 0.0,
                    prompt_lens: Sequence[int] = (16, 32),
                    gen_tokens: Sequence[int] = (8, 16),
                    temperature: float = 0.0, top_k: int = 0,
                    top_p: float = 1.0, eos_id: int = -1,
                    max_len: int = 0) -> List[Request]:
    """Generate a seeded synthetic trace.

    ``rate`` is the Poisson arrival rate in requests/second (0 = everything
    arrives at t=0, the closed-loop/bench case).  ``prompt_lens`` and
    ``gen_tokens`` are choice sets sampled per request.  When ``max_len`` is
    given, generation budgets are clipped so ``P + max_new <= max_len``.
    """
    if n_requests <= 0:
        raise ValueError(f"n_requests must be positive, got {n_requests}")
    rng = np.random.default_rng(seed)
    if rate > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n_requests))
    else:
        arrivals = np.zeros(n_requests)
    out: List[Request] = []
    for i in range(n_requests):
        P = int(rng.choice(list(prompt_lens)))
        G = int(rng.choice(list(gen_tokens)))
        if max_len:
            if P >= max_len:
                raise ValueError(
                    f"prompt_len {P} does not fit max_len {max_len}")
            G = min(G, max_len - P)
        prompt = rng.integers(3, vocab, size=P, dtype=np.int32)
        out.append(Request(
            rid=i, prompt=prompt, max_new=G, arrival_s=float(arrivals[i]),
            seed=seed * 100003 + i, temperature=float(temperature),
            top_k=int(top_k), top_p=float(top_p), eos_id=int(eos_id),
        ))
    return out


def shared_prefix_trace(n_requests: int, vocab: int, *, prefix_len: int,
                        n_prefixes: int = 1, seed: int = 0, rate: float = 0.0,
                        prompt_lens: Sequence[int] = (8, 16),
                        gen_tokens: Sequence[int] = (8, 16),
                        temperature: float = 0.0, top_k: int = 0,
                        top_p: float = 1.0, eos_id: int = -1,
                        max_len: int = 0) -> List[Request]:
    """Prefix-heavy trace: the system-prompt serving pattern.

    ``n_prefixes`` shared prefixes of ``prefix_len`` tokens are drawn once
    and assigned round-robin; each request's prompt is its prefix plus a
    unique tail whose length is sampled from ``prompt_lens`` (which are
    TAIL lengths here — total prompt length is ``prefix_len + tail``).
    The first request on each prefix is a cold prefill; later ones should
    hit the radix prefix cache.  Everything else matches
    :func:`synthetic_trace` (Poisson arrivals, per-request seeds, budget
    clipping against ``max_len``).
    """
    if n_requests <= 0:
        raise ValueError(f"n_requests must be positive, got {n_requests}")
    if prefix_len < 1 or n_prefixes < 1:
        raise ValueError(f"need prefix_len >= 1 and n_prefixes >= 1, got "
                         f"{prefix_len}/{n_prefixes}")
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(3, vocab, size=prefix_len, dtype=np.int32)
                for _ in range(n_prefixes)]
    if rate > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n_requests))
    else:
        arrivals = np.zeros(n_requests)
    out: List[Request] = []
    for i in range(n_requests):
        tail_len = int(rng.choice(list(prompt_lens)))
        G = int(rng.choice(list(gen_tokens)))
        P = prefix_len + tail_len
        if max_len:
            if P >= max_len:
                raise ValueError(
                    f"prompt_len {P} (prefix {prefix_len} + tail "
                    f"{tail_len}) does not fit max_len {max_len}")
            G = min(G, max_len - P)
        tail = rng.integers(3, vocab, size=tail_len, dtype=np.int32)
        prompt = np.concatenate([prefixes[i % n_prefixes], tail])
        out.append(Request(
            rid=i, prompt=prompt, max_new=G, arrival_s=float(arrivals[i]),
            seed=seed * 100003 + i, temperature=float(temperature),
            top_k=int(top_k), top_p=float(top_p), eos_id=int(eos_id),
        ))
    return out


def static_trace(prompts: np.ndarray, gen: int, *, seed: int = 0,
                 temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
                 eos_id: int = -1) -> List[Request]:
    """All-at-once trace from a [B, P] prompt batch (the static-batch shim)."""
    return [
        Request(rid=i, prompt=np.asarray(prompts[i], np.int32), max_new=gen,
                arrival_s=0.0, seed=seed * 100003 + i,
                temperature=temperature, top_k=top_k, top_p=top_p,
                eos_id=eos_id)
        for i in range(len(prompts))
    ]


def percentiles(xs: Sequence[float],
                qs: Sequence[int] = (50, 95, 99)) -> Optional[Dict[str, float]]:
    """{"p50": ..., ...} summary of a latency sample (None when empty)."""
    if not len(xs):
        return None
    arr = np.asarray(xs, np.float64)
    return {f"p{q}": float(np.percentile(arr, q)) for q in qs}


def trace_summary(trace: List[Request]) -> Dict[str, Any]:
    return {
        "n_requests": len(trace),
        "prompt_tokens": int(sum(r.prompt_len for r in trace)),
        "gen_budget": int(sum(r.max_new for r in trace)),
        "span_s": float(max(r.arrival_s for r in trace)) if trace else 0.0,
    }
