"""Continuous-batching serving engine, dense slot pool
(port of ``repro.serve.engine``).

The KV cache is a dense slot pool (``model.init_cache(n_slots, max_len)``,
every leaf ``[L, n_slots, max_len, ...]``).  A host scheduler admits queued
requests into free slots — one prefill per request straight into its slot
row — and every tick decodes all slots in one step
(``train.steps.make_engine_step``); slots retire on EOS or budget.  Cache
and slot state live on the device and are updated in place.  The host read
of each tick's ``sampled``/``finished`` (and of each admission's first
token) is the sync point that ``jax.device_get`` was in JAX, so the host
clock around it measures device work.

This slice ports the greedy, dense engine that the static-batch shim
drives.  The paged cache with prefix sharing and chunked prefill, the
sampling head, request deadlines and the no-progress watchdog, sharded
serving, telemetry spans and fault injection come with later slices and
raise here.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..device import resolve_device
from ..train import steps as ST
from .workload import Request, percentiles


class EngineError(Exception):
    """Engine misconfiguration (unservable arch, request does not fit)."""


def load_params(model, ckpt: str = "", seed: int = 0, device=None):
    """Params for serving: random init from ``seed`` with a
    ``torch.Generator`` on ``device`` (the card unless the caller asks for
    the CPU).  Restoring a checkpoint comes with the checkpoint slice."""
    if ckpt:
        raise NotImplementedError(
            "serving from a checkpoint comes with the checkpoint slice of "
            "the port; run without ckpt for seeded random weights")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return model.init(gen)


def _params_device(params) -> torch.device:
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


class ServeEngine:
    """Continuous-batching engine over one model (dense slot pool)."""

    def __init__(self, model, params, *, n_slots: int, max_len: int,
                 cache_dtype=torch.bfloat16, greedy: bool = True,
                 block_len: Optional[int] = None,
                 log: Optional[Callable[[str], None]] = None):
        """``greedy=True`` is the only tick this slice builds.
        ``block_len`` must be None or 0 (dense pool): the paged cache comes
        with the paged-engine slice, and a paged request never goes dense
        silently."""
        cfg = model.cfg
        if cfg.arch_type == "audio" or cfg.n_patches:
            raise EngineError(
                f"{cfg.name}: the serving engine drives text decoders")
        if n_slots < 1 or max_len < 2:
            raise EngineError(f"need n_slots >= 1 and max_len >= 2, got "
                              f"{n_slots}/{max_len}")
        if block_len is not None and block_len > 0 \
                or (block_len is None and model.supports_paged_cache()):
            raise NotImplementedError(
                "the paged KV cache comes with the paged-engine slice of the "
                "port; set block_len=0 for the dense slot pool")
        if not greedy:
            raise NotImplementedError(
                "sampled requests come with the sampling slice of the port; "
                "build the engine with greedy=True")
        self.model = model
        self.params = params
        self.device = _params_device(params)
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self.cache_dtype = cache_dtype
        self.log = log or (lambda msg: None)
        self.greedy = True
        self.paged = False
        self._tick = ST.make_engine_step(model, greedy=True, paged=False)

    # -- device state --------------------------------------------------------
    def _init_pool(self):
        cache = self.model.init_cache(self.n_slots, self.max_len,
                                      self.cache_dtype, self.device)
        n, dev = self.n_slots, self.device
        i32 = dict(dtype=torch.int32, device=dev)
        slots = {
            "tokens": torch.zeros((n,), **i32),
            "pos": torch.zeros((n,), **i32),
            "active": torch.zeros((n,), dtype=torch.bool, device=dev),
            "n_gen": torch.zeros((n,), **i32),
            "max_gen": torch.ones((n,), **i32),
            "eos": torch.full((n,), -1, **i32),
        }
        return cache, slots

    @torch.no_grad()
    def _admit(self, cache, slots, prompt, slot: int, max_gen: int, eos: int):
        """Prefill one request into ``slot`` and write its slot state;
        returns the first token and whether the request already finished
        (both still on the device)."""
        logits, cache = self.model.prefill_into(
            self.params, {"tokens": prompt[None]}, cache, slot,
            max_len=self.max_len, cache_dtype=self.cache_dtype)
        tok = torch.argmax(logits[0], dim=-1).to(torch.int32)
        finished = (tok == eos) | (max_gen <= 1)
        slots["tokens"][slot] = tok
        slots["pos"][slot] = prompt.shape[0]
        slots["active"][slot] = ~finished
        slots["n_gen"][slot] = 1
        slots["max_gen"][slot] = max_gen
        slots["eos"][slot] = eos
        return cache, slots, tok, finished

    def _budget(self, r: Request) -> int:
        P = r.prompt_len
        if P < 1 or P >= self.max_len:
            raise EngineError(
                f"request {r.rid}: prompt_len {P} does not fit "
                f"max_len {self.max_len}")
        if r.temperature > 0:
            raise EngineError(
                f"request {r.rid}: temperature {r.temperature} on a "
                f"greedy-tick engine")
        if r.deadline_s > 0:
            raise EngineError(
                f"request {r.rid}: deadlines come with the paged-engine slice "
                f"of the port")
        return min(int(r.max_new), self.max_len - P)

    def _warmup(self, prompt_lens) -> float:
        """Run every path a trace will hit once against a sacrificial pool
        (one admission per distinct prompt length, then one tick), so the
        timed loop measures serving, not first-call set-up: cuBLAS handles,
        allocator growth, the kernel library's build and load."""
        t0 = time.perf_counter()
        cache, slots = self._init_pool()
        for P in sorted(set(prompt_lens)):
            cache, slots, _, _ = self._admit(
                cache, slots, torch.zeros((P,), dtype=torch.int64,
                                          device=self.device), 0, 1, -1)
        _, _, sampled, _ = self._tick(self.params, cache, slots)
        sampled.cpu()
        return time.perf_counter() - t0

    def step_probes(self, prompt: torch.Tensor) -> Dict[str, Callable[[], Any]]:
        """One admission and one decode tick, each as a callable that runs
        that step alone, for a profiler or a timer: ``"admit"`` prefills
        ``prompt`` (int64 ``[P]`` on the engine's device) into slot 0 and
        ``"tick"`` decodes every slot, over a pool of their own whose slots
        all hold ``prompt`` already.  Each call returns the step's device
        tensors without a host sync; the pool is updated in place."""
        cache, slots = self._init_pool()
        max_gen = self.max_len - int(prompt.shape[0])
        for s in range(self.n_slots):
            cache, slots, _, _ = self._admit(cache, slots, prompt, s, max_gen,
                                             -1)
        return {
            "admit": lambda: self._admit(cache, slots, prompt, 0, max_gen, -1),
            "tick": lambda: self._tick(self.params, cache, slots),
        }

    # -- the scheduler loop --------------------------------------------------
    def run(self, requests: Sequence[Request], *, realtime: bool = True,
            warmup: bool = True) -> Dict[str, Any]:
        """Serve a trace to completion; returns per-request rows + metrics.

        ``realtime=False`` ignores arrival offsets (closed loop).  Metrics:
        TTFT (arrival -> first token, queueing included), per-decode-token
        latency percentiles, tokens/s, slot utilisation.  The first token of
        every request comes from the prefill logits and counts to
        prefill/TTFT; only later tokens count as decode throughput.
        ``warmup`` time is reported as ``compile_s``, as in JAX.
        """
        pending = deque(sorted(requests, key=lambda r: (r.arrival_s, r.rid)))
        budgets = {r.rid: self._budget(r) for r in pending}
        compile_s = (self._warmup([r.prompt_len for r in pending])
                     if warmup else 0.0)
        cache, slots = self._init_pool()
        free: List[int] = list(range(self.n_slots))[::-1]
        slot_req: Dict[int, Request] = {}
        streams: Dict[int, List[int]] = {}
        rows: Dict[int, Dict[str, Any]] = {}
        ttfts: List[float] = []
        tpot: List[float] = []
        ticks = 0
        busy_slot_ticks = 0
        prefill_s = 0.0
        decode_s = 0.0
        timeline: List[Dict[str, Any]] = []
        t0 = time.perf_counter()

        def retire(slot: int, r: Request) -> None:
            stream = streams[r.rid]
            rows[r.rid].update(
                n_gen=len(stream),
                gen_ids=stream,
                finish=("eos" if r.eos_id >= 0 and stream[-1] == r.eos_id
                        else "length"),
                done_s=round(time.perf_counter() - t0, 6),
            )
            slot_req.pop(slot, None)
            free.append(slot)

        def do_tick() -> None:
            nonlocal cache, slots, ticks, busy_slot_ticks, decode_s
            ta = time.perf_counter()
            cache, slots, sampled, finished = self._tick(self.params, cache,
                                                         slots)
            sampled, finished = sampled.cpu(), finished.cpu()   # sync point
            dt = time.perf_counter() - ta
            decode_s += dt
            ticks += 1
            busy_slot_ticks += len(slot_req)
            for slot in list(slot_req):
                r = slot_req[slot]
                streams[r.rid].append(int(sampled[slot]))
                tpot.append(dt)
                if bool(finished[slot]):
                    retire(slot, r)
            if len(timeline) < 100_000:
                timeline.append({"t_s": round(time.perf_counter() - t0, 6),
                                 "queue": len(pending), "busy": len(slot_req)})

        def admit_dense(r: Request) -> None:
            nonlocal cache, slots, prefill_s
            slot = free.pop()
            ta = time.perf_counter()
            prompt = torch.as_tensor(r.prompt, dtype=torch.int64,
                                     device=self.device)
            cache, slots, tok, fin = self._admit(cache, slots, prompt, slot,
                                                 budgets[r.rid], r.eos_id)
            tok, fin = int(tok), bool(fin)                      # sync point
            tb = time.perf_counter()
            prefill_s += tb - ta
            arrival = r.arrival_s if realtime else 0.0
            ttfts.append(tb - t0 - arrival)
            streams[r.rid] = [tok]
            rows[r.rid] = {
                "id": r.rid, "slot": slot, "prompt_len": r.prompt_len,
                "max_new": budgets[r.rid], "arrival_s": arrival,
                "ttft_s": round(tb - t0 - arrival, 6),
                "queue_s": round(max(0.0, (ta - t0) - arrival), 6),
                "prefill_s": round(tb - ta, 6),
                "cached_tokens": 0,
                "prefill_chunks": 1,
            }
            slot_req[slot] = r
            if fin:
                retire(slot, r)

        while pending or slot_req:
            now = time.perf_counter() - t0
            while free and pending and (not realtime
                                        or pending[0].arrival_s <= now):
                admit_dense(pending.popleft())
                now = time.perf_counter() - t0
            if not slot_req:
                if pending and realtime:
                    time.sleep(min(max(pending[0].arrival_s - now, 0.0), 0.05))
                continue
            do_tick()

        elapsed = time.perf_counter() - t0
        gen_tokens = sum(len(s) for s in streams.values())
        decode_tokens = gen_tokens - len(streams)   # firsts belong to prefill
        util = (busy_slot_ticks / (ticks * self.n_slots)) if ticks else 0.0
        decode_tok_s = decode_tokens / decode_s if decode_s > 0 else 0.0
        admitted = list(rows.values())
        result: Dict[str, Any] = {
            "n_slots": self.n_slots,
            "max_len": self.max_len,
            "n_requests": len(rows),
            "completed": len(rows),
            # deadlines come with the paged-engine slice; the key stays so
            # the result matches JAX's
            "timeouts": 0,
            "generated_tokens": gen_tokens,
            "decode_tokens": decode_tokens,
            "compile_s": round(compile_s, 4),
            "elapsed_s": round(elapsed, 4),
            "prefill_s": round(prefill_s, 4),
            "decode_s": round(decode_s, 4),
            "ticks": ticks,
            "tok_s": int(gen_tokens / elapsed) if elapsed > 0 else 0,
            "decode_tok_s": int(decode_tok_s),
            "decode_tok_s_full": int(decode_tok_s / util) if util > 0 else 0,
            "slot_utilization": round(util, 4),
            "ttft_s": percentiles(ttfts),
            "queue_s": percentiles([w["queue_s"] for w in admitted]),
            # p90 beside JAX's p50/p95/p99: the port's chip run reports it
            "tpot_ms": percentiles([t * 1000 for t in tpot], (50, 90, 95, 99)),
            # the dense pool has no prefix cache: every admission is cold
            "prefill_cache_hit_rate": 0.0,
            "ttft_hit_s": None,
            "ttft_cold_s": percentiles([w["ttft_s"] for w in admitted]),
            "prefill_hit_s": None,
            "prefill_cold_s": percentiles([w["prefill_s"] for w in admitted]),
            "interleaved_decode_ticks": 0,
            "timeline": timeline,
            "requests": [rows[rid] for rid in sorted(rows)],
        }
        self.log(
            f"engine: {result['n_requests']} requests, "
            f"{gen_tokens} tokens in {elapsed:.3f}s "
            f"({result['tok_s']} tok/s, decode {result['decode_tok_s']} "
            f"tok/s, util {util:.0%})")
        return result
