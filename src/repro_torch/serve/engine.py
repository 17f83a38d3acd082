"""Continuous-batching serving engine (port of ``repro.serve.engine``).

Two cache layouts share one scheduler:

- **Paged** (the default when the arch supports it): the KV cache is a
  block pool (``model.init_paged_cache(n_blocks, block_len)``, every leaf
  ``[L, n_blocks + 1, block_len, ...]`` with one scratch block) and each
  slot owns a page-table row of physical block ids.  A radix prefix index
  (:mod:`repro_torch.serve.paging`) maps shared prompt prefixes onto
  refcounted pages, so a request whose prompt extends a cached stream only
  prefills its tail — and admission is *chunked*: fixed-shape prompt
  chunks interleave with decode ticks, so a long prefill never stalls
  in-flight decodes for more than one chunk.
- **Dense** slot rows (``model.init_cache(n_slots, max_len)``) for archs a
  block pool cannot express — sliding-window ring buffers, SSM state — and
  for ``block_len=0`` (the static shim pins it, as in JAX).

Every tick decodes all slots in one step (``train.steps.make_engine_step``:
decode + sampling head + stop flags); cache and slot state live on the
device and are updated in place.  The host reads each tick's ``sampled``
and ``finished`` with one copy, and each admission's first token — the
sync points that ``jax.device_get`` was in JAX, so the host clock around
them measures device work.  Slots retire on EOS, budget or deadline,
releasing their pages at once (prompt pages stay cached in the radix tree
until LRU eviction needs the space).

Determinism contract: at a fixed pool shape, a request's token stream
depends only on its own prompt, sampling settings and seed — never on slot
index, admission order, co-resident requests, or (paged) whether its
prefix came from the radix cache or a cold prefill.  Every program's
shapes are independent of the prompt (a chunk is always ``[1,
prefill_chunk]`` over the full ``max_pages * block_len`` view, a tick always
covers ``n_slots``), nothing branches on a request's contents, and the
sampling noise is a hash of ``(seed, generation index)``.
``docs/serving.md`` spells out the argument.

A ``fault_injector`` fires ``serve_stall`` inside the tick, before its
watchdog clock stops (a hung collective, simulated).

Sharded serving (``mesh`` and ``plan``, as in JAX): the params are laid
out by ``plans.param_shardings`` and the pool by ``plans.cache_shardings``
as DTensors, each rank allocating and writing only its block of the
cache; the slot state and the page table are plain tensors, the same on
every rank, which runs the same scheduler (the logits are gathered before
the sampling head, so every rank draws the same tokens).  A ``mesh``
without a ``plan`` serves unsharded, as in JAX.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import MetaGenerator, resolve_device
from ..train import steps as ST
from .paging import BlockAllocator, RadixPrefixIndex
from .sampling import request_key, sample_tokens, token_key
from .workload import Request, percentiles

DEFAULT_BLOCK_LEN = 16


class EngineError(Exception):
    """Engine misconfiguration (unservable arch, request does not fit)."""


def load_params(model, ckpt: str = "", seed: int = 0, device=None):
    """Params for serving on ``device`` (the card unless the caller asks
    for the CPU): restore a TRAINING checkpoint (the full ``{params, opt,
    step}`` train state, sharded-dir or legacy npz format) params-only, or
    random init from ``seed`` with a ``torch.Generator`` when no checkpoint
    is given.

    With a checkpoint the target tree is built on the ``meta`` device (as
    JAX uses ``jax.eval_shape``): no throwaway random init is allocated
    before the restore."""
    dev = resolve_device(device)
    if ckpt:
        from ..train.checkpoint import restore_params

        return restore_params(model.init(MetaGenerator()), ckpt, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return model.init(gen)


def _params_device(params) -> torch.device:
    while isinstance(params, dict):
        params = next(iter(params.values()))
    return params.device


class ServeEngine:
    """Continuous-batching engine over one model."""

    def __init__(self, model, params, *, n_slots: int, max_len: int,
                 cache_dtype=torch.bfloat16, mesh=None, plan=None,
                 greedy: bool = False, block_len: Optional[int] = None,
                 n_blocks: int = 0, prefill_chunk: int = 0,
                 prefix_cache: bool = True,
                 deadline_s: float = 0.0, watchdog_s: float = 0.0,
                 fault_injector=None, telemetry=None,
                 log: Optional[Callable[[str], None]] = None):
        """``greedy=True`` builds a sampler-free decode tick — use it when
        every request this engine will serve is greedy (the static shim);
        the engine rejects sampled requests then.

        ``block_len=None`` (default) auto-selects: paged KV cache with
        ``DEFAULT_BLOCK_LEN``-token pages when the arch supports it, the
        dense slot pool otherwise.  ``block_len=0`` forces dense;
        ``block_len>0`` forces paged (raising for unsupported archs).
        ``n_blocks=0`` sizes the pool to ``(n_slots + 1) * max_pages`` —
        full residency plus one request's worth of retained prefix pages.
        ``prefill_chunk`` (default ``2 * block_len``) is the fixed chunk
        the admission prefill is split into — the most a prefill may stall
        co-resident decodes, and the grid cached pages are canonical on
        (must be a multiple of ``block_len``).  ``prefix_cache=False`` keeps
        the block pool but disables radix matching/insertion.

        ``deadline_s`` is a wall deadline per request from its arrival (0 =
        none; ``Request.deadline_s`` overrides it per request);
        ``watchdog_s`` raises when one tick takes longer (0 = off; only sane
        with warm-up); ``fault_injector`` (a ``FaultInjector``) fires its
        ``serve_stall`` rows inside ticks.  ``telemetry`` (a ``TelemetryRecorder``) gets each
        request's ``serve/request|queued|prefill|decode`` spans and one
        ``serve_summary`` metric row a run.
        """
        cfg = model.cfg
        if cfg.arch_type == "audio" or cfg.n_patches:
            raise EngineError(
                f"{cfg.name}: the serving engine drives text decoders; "
                f"audio/vlm prompts need modality extras the slot scheduler "
                f"does not carry")
        if n_slots < 1 or max_len < 2:
            raise EngineError(f"need n_slots >= 1 and max_len >= 2, got "
                              f"{n_slots}/{max_len}")
        if deadline_s < 0 or watchdog_s < 0:
            raise EngineError(f"deadline_s/watchdog_s must be >= 0, got "
                              f"{deadline_s}/{watchdog_s}")
        self.model = model
        self.device = _params_device(params)
        if hasattr(mesh, "build"):
            mesh = mesh.build(self.device.type)
        self.mesh, self.plan = mesh, plan
        if mesh is not None and plan is not None:
            from ..models.transformer import DecoderLM, refuse_mesh
            from ..sharding import plans as PL

            if not isinstance(model, DecoderLM):
                raise NotImplementedError(
                    f"{type(model).__name__} under a plan comes with "
                    f"{PL.A8B}")
            refuse_mesh(cfg)
            self.mesh_ctx = PL.mesh_context(plan, mesh)
            psh, self.shard_warnings = PL.param_shardings(
                plan, mesh, params, model.param_axes())
            params = PL.distribute(params, psh)
        else:
            self.mesh_ctx = None
            self.shard_warnings = []
        self._ranks = mesh.size() if self.mesh_ctx is not None else 1
        self.params = params
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self.cache_dtype = cache_dtype
        self.deadline_s = float(deadline_s)
        self.watchdog_s = float(watchdog_s)
        # a fault injector for deterministic serve_stall chaos
        self.fault_injector = fault_injector
        self.telemetry = telemetry
        self.log = log or (lambda msg: None)
        supports_paged = model.supports_paged_cache()
        if block_len is None:
            self.block_len = DEFAULT_BLOCK_LEN if supports_paged else 0
        else:
            self.block_len = int(block_len)
            if self.block_len > 0 and not supports_paged:
                raise EngineError(
                    f"{cfg.name}: paged KV cache needs full-context "
                    f"attention decode layers (arch {cfg.arch_type}, window "
                    f"{cfg.window}); set block_len: 0 for the dense pool")
        self.paged = self.block_len > 0
        if self.paged:
            self.block_len = min(self.block_len, self.max_len)
            self.max_pages = -(-self.max_len // self.block_len)
            self.n_blocks = int(n_blocks) or (self.n_slots + 1) * self.max_pages
            if self.n_blocks < self.max_pages:
                raise EngineError(
                    f"n_blocks {self.n_blocks} cannot hold one max_len "
                    f"request ({self.max_pages} pages of {self.block_len})")
            chunk = int(prefill_chunk) or 2 * self.block_len
            if chunk < 1 or chunk % self.block_len:
                raise EngineError(
                    f"prefill_chunk {chunk} must be a positive multiple of "
                    f"block_len {self.block_len}: the chunk grid is what "
                    f"makes cached pages bitwise canonical")
            self.prefill_chunk = min(chunk, self.max_pages * self.block_len)
            self.prefix_cache = bool(prefix_cache)
            self._chunk = ST.make_prefill_chunk_step(model, self.mesh_ctx)
        else:
            self.max_pages = 0
            self.n_blocks = 0
            self.prefill_chunk = 0
            self.prefix_cache = False
        self.greedy = bool(greedy)
        self._tick = ST.make_engine_step(model, self.mesh_ctx,
                                         greedy=self.greedy, paged=self.paged)

    # -- device state --------------------------------------------------------
    def _init_pool(self):
        """A fresh pool and slot state.  Under a mesh each leaf of the pool
        is a DTensor laid out by ``plans.cache_shardings`` (JAX's rule at
        ``n_blocks`` or ``n_slots``), each rank allocating only its block
        (``plans.pool_zeros``: a paged pool's scratch block on every
        rank)."""
        dev = self.device if self.mesh_ctx is None else torch.device("meta")
        if self.paged:
            cache = self.model.init_paged_cache(self.n_blocks, self.block_len,
                                                self.cache_dtype, dev)
        else:
            cache = self.model.init_cache(self.n_slots, self.max_len,
                                          self.cache_dtype, dev)
        if self.mesh_ctx is not None:
            from ..sharding import plans as PL

            csh = PL.cache_shardings(
                self.plan, self.mesh, cache,
                self.n_blocks if self.paged else self.n_slots,
                paged=self.paged)
            cache = PL.pool_zeros(cache, csh, self.device, paged=self.paged)
        n, dev = self.n_slots, self.device
        i32 = dict(dtype=torch.int32, device=dev)
        slots = {
            "tokens": torch.zeros((n,), **i32),
            "pos": torch.zeros((n,), **i32),
            "active": torch.zeros((n,), dtype=torch.bool, device=dev),
            "n_gen": torch.zeros((n,), **i32),
            "max_gen": torch.ones((n,), **i32),
            "eos": torch.full((n,), -1, **i32),
            "key": torch.zeros((n, 2), dtype=torch.int64, device=dev),
            "temperature": torch.zeros((n,), dtype=torch.float32, device=dev),
            "top_k": torch.zeros((n,), **i32),
            "top_p": torch.ones((n,), dtype=torch.float32, device=dev),
        }
        return cache, slots

    def _reset_paging(self):
        """Fresh allocator / radix tree / page table for one ``run``."""
        self._alloc = BlockAllocator(self.n_blocks)
        self._radix = RadixPrefixIndex(self.block_len, self._alloc)
        self._pt = np.full((self.n_slots, self.max_pages), -1, np.int32)
        self._pt_dev = None                  # lazily refreshed device copy
        self._req_blocks: Dict[int, List[int]] = {}   # rid -> mapped blocks

    def _pages_dev(self):
        """The device copy of the host page table, copied (a private copy,
        so later host edits cannot reach it) only after it changed."""
        if self._pt_dev is None:
            self._pt_dev = torch.tensor(self._pt, device=self.device)
        return self._pt_dev

    # -- admission pieces (device work, no host sync) ------------------------
    def _set_request(self, slots, slot: int, r: Request, budget: int):
        """A request's sampling key and knobs, budget and stop token."""
        key = request_key(r.seed).tolist()
        slots["key"][slot, 0] = key[0]
        slots["key"][slot, 1] = key[1]
        slots["temperature"][slot] = float(r.temperature)
        slots["top_k"][slot] = int(r.top_k)
        slots["top_p"][slot] = float(r.top_p)
        slots["max_gen"][slot] = int(budget)
        slots["eos"][slot] = int(r.eos_id)

    def _first_token(self, logits, slots, slot: int):
        """Generation index 0 from the prefill's last-row logits [1, V],
        with the slot's key and knobs (the same head as the tick)."""
        logits = ST.full_logits(logits)
        if self.greedy:
            return torch.argmax(logits[0], dim=-1).to(torch.int32)
        s = slice(slot, slot + 1)
        return sample_tokens(logits, token_key(slots["key"][s], 0),
                             slots["temperature"][s], slots["top_k"][s],
                             slots["top_p"][s])[0]

    @staticmethod
    def _start(slots, slot: int, tok, prompt_len: int) -> None:
        """The slot decodes from ``prompt_len`` on, ``tok`` its first token;
        it stays inactive when that token already finishes the request."""
        slots["tokens"][slot] = tok
        slots["pos"][slot] = prompt_len
        slots["n_gen"][slot] = 1
        slots["active"][slot] = ((tok != slots["eos"][slot])
                                 & (slots["max_gen"][slot] > 1))

    def _admit_dense(self, cache, slots, prompt, slot: int):
        """Prefill ``prompt`` (int64 [P] on the device) into a dense slot
        row; returns the cache and the first token, still on the device."""
        logits, cache = self.model.prefill_into(
            self.params, {"tokens": prompt[None]}, cache, slot,
            max_len=self.max_len, cache_dtype=self.cache_dtype,
            mesh_ctx=self.mesh_ctx)
        tok = self._first_token(logits, slots, slot)
        self._start(slots, slot, tok, prompt.shape[0])
        return cache, tok

    def _budget(self, r: Request) -> int:
        P = r.prompt_len
        if P < 1 or P >= self.max_len:
            raise EngineError(
                f"request {r.rid}: prompt_len {P} does not fit "
                f"max_len {self.max_len}")
        if self.greedy and r.temperature > 0:
            raise EngineError(
                f"request {r.rid}: temperature {r.temperature} on a "
                f"greedy-tick engine (built with greedy=True)")
        return min(int(r.max_new), self.max_len - P)

    def _warmup(self, prompt_lens) -> float:
        """Run every path a trace will hit once against a sacrificial pool,
        so the timed loop measures serving, not first-call set-up: cuBLAS
        handles, allocator growth, the kernel library's build and load.
        Paged mode runs a fixed set (chunk, first token, tick) whatever the
        prompt lengths; dense mode one admission per distinct length."""
        t0 = time.perf_counter()
        cache, slots = self._init_pool()
        probe = Request(rid=-1, prompt=np.zeros((1,), np.int32), max_new=1)
        self._set_request(slots, 0, probe, 1)
        if self.paged:
            pages = torch.zeros((self.n_slots, self.max_pages),
                                dtype=torch.int32, device=self.device)
            logits, cache = self._chunk(
                self.params, cache, pages[0],
                torch.zeros((self.prefill_chunk,), dtype=torch.int64,
                            device=self.device), 0, 1)
            self._start(slots, 0, self._first_token(logits, slots, 0), 1)
            out = self._tick(self.params, cache, slots, pages)
        else:
            for P in sorted(set(prompt_lens)):
                cache, _ = self._admit_dense(
                    cache, slots, torch.zeros((P,), dtype=torch.int64,
                                              device=self.device), 0)
            out = self._tick(self.params, cache, slots)
        out[2].cpu()
        return time.perf_counter() - t0

    def step_probes(self, prompt: torch.Tensor, *, temperature: float = 0.0,
                    top_k: int = 0,
                    top_p: float = 1.0) -> Dict[str, Callable[[], Any]]:
        """One admission and one decode tick, each as a callable that runs
        that step alone, for a profiler or a timer: ``"admit"`` prefills
        ``prompt`` (int64 ``[P]`` on the engine's device; paged: in
        ``ceil(P / prefill_chunk)`` chunks, one when it fits a chunk) into
        slot 0 and samples its first token, and ``"tick"`` decodes every
        slot, over a pool of their own whose slots all hold ``prompt``
        already, each with the given sampling knobs (a paged pool gives
        slot ``s`` the blocks ``s * max_pages ...``).  Each call returns
        ``(cache, slots, tokens, finished)`` as device tensors without a host
        sync; the pool is updated in place."""
        cache, slots = self._init_pool()
        P = int(prompt.shape[0])
        max_gen = self.max_len - P
        pages = None
        if self.paged:
            if self.n_blocks < self.n_slots * self.max_pages:
                raise EngineError("step_probes needs n_blocks >= n_slots * "
                                  "max_pages")
            pages = torch.arange(self.n_slots * self.max_pages,
                                 dtype=torch.int32, device=self.device
                                 ).reshape(self.n_slots, self.max_pages)
            C = self.prefill_chunk
            toks = torch.zeros((-(-P // C) * C,), dtype=torch.int64,
                               device=self.device)
            toks[:P] = prompt

        def admit(slot: int = 0):
            nonlocal cache
            if self.paged:
                for lo in range(0, P, C):
                    logits, cache = self._chunk(self.params, cache,
                                                pages[slot], toks[lo:lo + C],
                                                lo, min(C, P - lo))
                tok = self._first_token(logits, slots, slot)
                self._start(slots, slot, tok, P)
            else:
                cache, tok = self._admit_dense(cache, slots, prompt, slot)
            return cache, slots, tok, ~slots["active"][slot]

        for s in range(self.n_slots):
            r = Request(rid=s, prompt=np.zeros((P,), np.int32),
                        max_new=max_gen, seed=s, temperature=temperature,
                        top_k=top_k, top_p=top_p)
            self._set_request(slots, s, r, max_gen)
            admit(s)

        def tick():
            if self.paged:
                return self._tick(self.params, cache, slots, pages)
            return self._tick(self.params, cache, slots)

        return {"admit": admit, "tick": tick}

    def _now(self, t0: float) -> float:
        """Seconds since ``t0`` on the clock the scheduler decides by.
        Under a mesh of more than one rank every rank runs the scheduler,
        and each decision must be the same on all of them (the collectives
        of a tick or an admission must match), so rank 0's reading is
        broadcast: arrivals and deadlines are judged by one clock."""
        now = time.perf_counter() - t0
        if self._ranks > 1:
            import torch.distributed as dist

            t = torch.tensor([now], dtype=torch.float64, device=self.device)
            dist.broadcast(t, src=0)
            now = float(t)
        return now

    # -- the scheduler loop --------------------------------------------------
    @torch.no_grad()
    def run(self, requests: Sequence[Request], *, realtime: bool = True,
            warmup: bool = True) -> Dict[str, Any]:
        """Serve a trace to completion; returns per-request rows + metrics.

        ``realtime=False`` ignores arrival offsets (closed loop, maximum
        pressure).  Metrics: TTFT (arrival -> first token, queueing
        included; split hit/cold in paged mode), per-decode-token latency
        percentiles, tokens/s, slot utilisation, and — paged — prefix-cache
        hit rate plus allocator/eviction counters.  The first token of every
        request comes from the prefill logits and counts to prefill/TTFT;
        only later tokens count as decode throughput.  ``warmup`` time is
        reported as ``compile_s``, as in JAX.
        """
        pending = deque(sorted(requests, key=lambda r: (r.arrival_s, r.rid)))
        budgets = {r.rid: self._budget(r) for r in pending}
        compile_s = (self._warmup([r.prompt_len for r in pending])
                     if warmup else 0.0)
        cache, slots = self._init_pool()
        if self.paged:
            self._reset_paging()
        dev = self.device
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
        interleaved_ticks = 0
        cached_prompt_tokens = 0
        total_prompt_tokens = 0
        timeouts = 0
        tel = self.telemetry
        do_spans = tel is not None and getattr(tel, "spans", False)
        # (t_admit_begin, t_first_token) per rid, absolute perf_counter
        # readings: the span anchors emitted when the request retires
        span_times: Dict[int, Any] = {}
        # one occupancy sample per decode tick: queue depth, busy slots and
        # (paged) free pool blocks
        timeline: List[Dict[str, Any]] = []
        # deadlines cost a scan per loop iteration: skip it entirely for the
        # (default) deadline-free workload
        deadlines_on = self.deadline_s > 0 or any(
            r.deadline_s > 0 for r in pending)

        def req_expiry(r: Request):
            """Absolute wall time (vs t0) this request must finish by."""
            dl = r.deadline_s or self.deadline_s
            if dl <= 0:
                return None
            return (r.arrival_s if realtime else 0.0) + dl

        t0 = time.perf_counter()

        def retire(slot: int, r: Request, finish: str = "") -> None:
            stream = streams[r.rid]
            t_ret = time.perf_counter()
            rows[r.rid].update(
                n_gen=len(stream),
                gen_ids=stream,
                finish=finish or ("eos" if r.eos_id >= 0
                                  and stream[-1] == r.eos_id
                                  else "length"),
                done_s=round(t_ret - t0, 6),
            )
            anchors = span_times.pop(r.rid, None)
            if do_spans and anchors is not None:
                t_adm, t_first = anchors
                t_arr = t0 + rows[r.rid]["arrival_s"]
                row = rows[r.rid]
                req = tel.span_row(
                    "serve/request", t_arr, t_ret, rid=r.rid, slot=slot,
                    prompt_len=r.prompt_len, n_gen=len(stream),
                    finish=row["finish"])
                tel.span_row("serve/queued", t_arr, t_adm, parent=req,
                             rid=r.rid)
                tel.span_row("serve/prefill", t_adm, t_first, parent=req,
                             rid=r.rid, cached_tokens=row["cached_tokens"],
                             chunks=row["prefill_chunks"])
                tel.span_row("serve/decode", t_first, t_ret, parent=req,
                             rid=r.rid)
            slot_req.pop(slot, None)
            free.append(slot)
            if self.paged:
                # drop this request's references; pages also held by the
                # radix tree survive for future prefix hits, private tail
                # pages free immediately
                blocks = self._req_blocks.pop(r.rid, None)
                if blocks:
                    self._alloc.release(blocks)
                self._pt[slot, :] = -1
                self._pt_dev = None

        def do_tick() -> None:
            nonlocal cache, slots, ticks, busy_slot_ticks, decode_s
            ta = time.perf_counter()
            if self.fault_injector is not None:
                stall = self.fault_injector.fire("serve_stall")
                if stall is not None and stall.seconds > 0:
                    time.sleep(stall.seconds)  # a hung collective, simulated
            if self.paged:
                cache, slots, sampled, finished = self._tick(
                    self.params, cache, slots, self._pages_dev())
            else:
                cache, slots, sampled, finished = self._tick(
                    self.params, cache, slots)
            # one copy to the host: the tick's sync point
            sampled, finished = torch.stack(
                [sampled, finished.to(torch.int32)]).cpu().tolist()
            dt = time.perf_counter() - ta
            if self.watchdog_s > 0 and dt > self.watchdog_s:
                raise EngineError(
                    f"no-progress watchdog: tick {ticks + 1} took {dt:.3f}s "
                    f"(> watchdog_s={self.watchdog_s}) with "
                    f"{len(slot_req)} request(s) in flight")
            decode_s += dt
            ticks += 1
            busy_slot_ticks += len(slot_req)
            for slot in list(slot_req):
                r = slot_req[slot]
                streams[r.rid].append(sampled[slot])
                tpot.append(dt)
                if finished[slot]:
                    retire(slot, r)
            if len(timeline) < 100_000:
                sample = {"t_s": round(time.perf_counter() - t0, 6),
                          "queue": len(pending), "busy": len(slot_req)}
                if self.paged:
                    sample["free_blocks"] = int(self._alloc.n_free)
                timeline.append(sample)

        def admit_dense(r: Request) -> None:
            nonlocal cache, prefill_s
            slot = free.pop()
            ta = time.perf_counter()
            self._set_request(slots, slot, r, budgets[r.rid])
            prompt = torch.as_tensor(np.asarray(r.prompt, np.int64),
                                     device=dev)
            cache, tok = self._admit_dense(cache, slots, prompt, slot)
            tok = int(tok)                                   # sync point
            tb = time.perf_counter()
            prefill_s += tb - ta
            finish_admission(r, slot, tok, tb - ta, tb, cached=0, n_chunks=1,
                             t_admit0=ta)

        def admit_paged(r: Request) -> bool:
            """Map pages, prefill the un-cached tail in fixed-size chunks
            (interleaving one decode tick between chunks so co-resident
            streams never stall longer than one chunk), sample the first
            token, and publish the prompt's full pages to the radix tree.
            Returns False when the pool cannot hold the request yet."""
            nonlocal cache, prefill_s, interleaved_ticks
            nonlocal cached_prompt_tokens, total_prompt_tokens
            P, budget = r.prompt_len, budgets[r.rid]
            bl, C = self.block_len, self.prefill_chunk
            prompt = [int(t) for t in r.prompt]
            n_pages_req = -(-(P + budget) // bl)
            matched = []
            if self.prefix_cache:
                # match whole pages, capped one token short of the prompt
                # (the last token must be recomputed for first-token logits)
                # and floored to the chunk grid: the un-cached tail then
                # starts exactly where a cold prefill's chunk would, which
                # is what keeps hit == cold bitwise
                matched = self._radix.match(prompt, ((P - 1) // C) * C)
                keep = (len(matched) * bl // C) * C // bl
                matched = matched[:keep]
            n_fresh = n_pages_req - len(matched)
            if n_fresh > self._alloc.n_free:
                self._radix.evict(n_fresh)
            if n_fresh > self._alloc.n_free:
                if not slot_req:
                    raise EngineError(
                        f"request {r.rid}: needs {n_fresh} blocks, "
                        f"{self._alloc.n_free}/{self.n_blocks} free with no "
                        f"requests in flight — pool too small")
                return False        # wait for a retirement
            ta = time.perf_counter()
            t_adm0 = ta             # admission begin (ta moves per chunk)
            for node in matched:
                self._alloc.retain(node.block)
            blocks = [n.block for n in matched] + self._alloc.alloc(n_fresh)
            slot = free.pop()
            self._pt[slot, :] = -1
            self._pt[slot, :len(blocks)] = blocks
            self._pt_dev = None
            self._req_blocks[r.rid] = blocks
            S = len(matched) * bl
            cached_prompt_tokens += S
            total_prompt_tokens += P
            n_chunks = -(-(P - S) // C)
            # the page row and the zero-padded tail go to the device in one
            # copy each; chunk ci reads toks[ci * C:(ci + 1) * C]
            row_dev = torch.tensor(self._pt[slot], device=dev)
            toks = np.zeros((n_chunks * C,), np.int64)
            toks[:P - S] = prompt[S:]
            toks = torch.as_tensor(toks, device=dev)
            self._set_request(slots, slot, r, budget)
            logits = None
            for ci in range(n_chunks):
                lo = S + ci * C
                logits, cache = self._chunk(
                    self.params, cache, row_dev, toks[ci * C:(ci + 1) * C],
                    lo, min(C, P - lo))
                if ci < n_chunks - 1 and slot_req:
                    prefill_s += time.perf_counter() - ta
                    do_tick()       # co-residents advance between chunks
                    interleaved_ticks += 1
                    ta = time.perf_counter()
            tok = self._first_token(logits, slots, slot)
            self._start(slots, slot, tok, P)
            tok = int(tok)                                   # sync point
            tb = time.perf_counter()
            prefill_s += tb - ta
            if self.prefix_cache:
                # publish the prompt's full pages (chunk-written, canonical);
                # existing nodes win, so a re-derived duplicate page stays
                # private and frees at retire
                self._radix.insert(prompt[:(P // bl) * bl], blocks)
            finish_admission(r, slot, tok, tb - ta, tb, cached=S,
                             n_chunks=n_chunks, t_admit0=t_adm0)
            return True

        def finish_admission(r, slot, tok, admit_s, tb, *, cached, n_chunks,
                             t_admit0):
            arrival = r.arrival_s if realtime else 0.0
            ttft = tb - t0 - arrival
            ttfts.append(ttft)
            streams[r.rid] = [tok]
            # queue_s is the span the request sat unadmitted (arrival ->
            # admission begin): with prefill_s it decomposes TTFT into
            # queueing vs compute (interleaved decode ticks during a chunked
            # admission account for any remainder)
            queue_s = max(0.0, (t_admit0 - t0) - arrival)
            rows[r.rid] = {
                "id": r.rid, "slot": slot, "prompt_len": r.prompt_len,
                "max_new": budgets[r.rid], "arrival_s": arrival,
                "ttft_s": round(ttft, 6),
                "queue_s": round(queue_s, 6),
                "prefill_s": round(admit_s, 6),
                "cached_tokens": cached,
                "prefill_chunks": n_chunks,
            }
            span_times[r.rid] = (t_admit0, tb)
            slot_req[slot] = r
            if (r.eos_id >= 0 and tok == r.eos_id) or budgets[r.rid] <= 1:
                retire(slot, r)

        while pending or slot_req:
            now = self._now(t0)
            if deadlines_on and pending:
                # queued requests past their deadline retire unserved —
                # admitting them would spend prefill on a dead answer
                keep: deque = deque()
                for r in pending:
                    exp = req_expiry(r)
                    if exp is not None and now > exp:
                        rows[r.rid] = {
                            "id": r.rid, "slot": -1,
                            "prompt_len": r.prompt_len,
                            "max_new": budgets[r.rid],
                            "arrival_s": r.arrival_s if realtime else 0.0,
                            "cached_tokens": 0, "prefill_chunks": 0,
                            "n_gen": 0, "gen_ids": [],
                            "finish": "timeout",
                            "done_s": round(now, 6),
                        }
                        timeouts += 1
                    else:
                        keep.append(r)
                pending = keep
            while free and pending and (not realtime
                                        or pending[0].arrival_s <= now):
                r = pending[0]
                if self.paged:
                    if not admit_paged(r):
                        break
                else:
                    admit_dense(r)
                pending.popleft()
                now = self._now(t0)
            if not slot_req:
                if pending and realtime:
                    time.sleep(min(max(pending[0].arrival_s - now, 0.0), 0.05))
                continue
            do_tick()
            if deadlines_on and slot_req:
                now = self._now(t0)
                for slot in list(slot_req):
                    r = slot_req[slot]
                    exp = req_expiry(r)
                    if exp is not None and now > exp \
                            and "n_gen" not in rows[r.rid]:
                        # stop the slot on the device too (JAX leaves it
                        # decoding): a live slot's position would run past
                        # max_len, where the dense cache write has no row
                        slots["active"][slot] = False
                        retire(slot, r, finish="timeout")
                        timeouts += 1

        elapsed = time.perf_counter() - t0
        gen_tokens = sum(len(s) for s in streams.values())
        decode_tokens = gen_tokens - len(streams)   # firsts belong to prefill
        util = (busy_slot_ticks / (ticks * self.n_slots)) if ticks else 0.0
        decode_tok_s = decode_tokens / decode_s if decode_s > 0 else 0.0
        # queued-expired rows were never admitted (no prefill/ttft sample)
        admitted = [w for w in rows.values() if "prefill_s" in w]
        hit = [w for w in admitted if w["cached_tokens"] > 0]
        cold = [w for w in admitted if w["cached_tokens"] == 0]
        result: Dict[str, Any] = {
            "n_slots": self.n_slots,
            "max_len": self.max_len,
            "n_requests": len(rows),
            "completed": sum(1 for row in rows.values()
                             if row.get("finish") in ("eos", "length")),
            "timeouts": timeouts,
            "generated_tokens": gen_tokens,
            "decode_tokens": decode_tokens,
            "compile_s": round(compile_s, 4),
            "elapsed_s": round(elapsed, 4),
            "prefill_s": round(prefill_s, 4),
            "decode_s": round(decode_s, 4),
            "ticks": ticks,
            "tok_s": int(gen_tokens / elapsed) if elapsed > 0 else 0,
            "decode_tok_s": int(decode_tok_s),
            # occupancy-normalised: decode throughput at 100% occupancy
            "decode_tok_s_full": int(decode_tok_s / util) if util > 0 else 0,
            "slot_utilization": round(util, 4),
            "ttft_s": percentiles(ttfts),
            "queue_s": percentiles([w["queue_s"] for w in admitted]),
            # p90 beside JAX's p50/p95/p99: the port's chip run reports it
            "tpot_ms": percentiles([t * 1000 for t in tpot], (50, 90, 95, 99)),
            "prefill_cache_hit_rate": (
                round(cached_prompt_tokens / total_prompt_tokens, 4)
                if total_prompt_tokens else 0.0),
            "ttft_hit_s": percentiles([w["ttft_s"] for w in hit]),
            "ttft_cold_s": percentiles([w["ttft_s"] for w in cold]),
            "prefill_hit_s": percentiles([w["prefill_s"] for w in hit]),
            "prefill_cold_s": percentiles([w["prefill_s"] for w in cold]),
            "interleaved_decode_ticks": interleaved_ticks,
            "timeline": timeline,
            "requests": [rows[rid] for rid in sorted(rows)],
        }
        if self.paged:
            result["paging"] = {
                "block_len": self.block_len,
                "n_blocks": self.n_blocks,
                "max_pages": self.max_pages,
                "prefill_chunk": self.prefill_chunk,
                "prefix_cache": self.prefix_cache,
                "peak_blocks": int(self._alloc.peak_used),
                "free_blocks": int(self._alloc.n_free),
                "cached_blocks": int(self._radix.n_nodes),
                "evictions": int(self._radix.evictions),
            }
        if tel is not None:
            headline = {
                "tok_s": result["tok_s"],
                "decode_tok_s": result["decode_tok_s"],
                "slot_utilization": result["slot_utilization"],
                "completed": result["completed"],
                "ticks": ticks,
            }
            for key in ("ttft_s", "queue_s", "tpot_ms"):
                p = result.get(key) or {}
                if "p50" in p:
                    headline[f"{key}_p50"] = p["p50"]
            tel.metric(None, headline, phase="serve_summary")
        self.log(
            f"engine: {result['n_requests']} requests, "
            f"{gen_tokens} tokens in {elapsed:.3f}s "
            f"({result['tok_s']} tok/s, decode {result['decode_tok_s']} "
            f"tok/s, util {util:.0%}, "
            f"hit rate {result['prefill_cache_hit_rate']:.0%})")
        return result
