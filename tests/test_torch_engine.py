"""The port's continuous-batching engine — paged KV cache, radix prefix
sharing, chunked prefill, the sampled tick, deadlines and the watchdog —
against the JAX package's, on the CPU.

Reduced qwen1.5-0.5b (2 layers, QKV bias, tied embeddings) with JAX's params
carried across by ``repro_torch.bridge``; traces come from both packages'
seeded numpy workloads.  Two kinds of check:

- the determinism contract inside the port, with ``==``: a request's stream
  does not depend on its slot, co-residents or admission order, on whether
  its prefix was a cache hit or a cold prefill, or on ``prefix_cache``
  (the ports of ``tests/test_serve_paging.py``'s gates);
- parity with JAX.  The serving path is bf16 end to end, and each package
  rounds at its own places, so logits are held to ``LOGIT_TOL`` = 3e-2 and
  the bf16 K/V pages to ``CACHE_TOL`` = 6e-2, the bounds and reasons of
  ``tests/test_torch_serve.py``.  Streams are equal, or part at a near-tie:
  at the first differing token, moving each of JAX's logits (teacher-forced
  through JAX's paged programs) by at most ``LOGIT_TOL`` — down for the
  tokens that beat the port's under JAX's own noise, up for the rest —
  makes JAX's own sampler draw the port's token.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.attention as JA
import repro_torch.models.attention as PA
from repro.config.resolver import load_yaml
from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.paging import BlockAllocator as JaxBlockAllocator
from repro.serve.sampling import sample_tokens as jax_sample_tokens
from repro.serve.workload import shared_prefix_trace as jax_shared_prefix_trace
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_reduced
from repro_torch.device import NoDeviceError
from repro_torch.models import build_model
from repro_torch.serve.engine import EngineError, ServeEngine, load_params
from repro_torch.serve.paging import (BlockAllocator, OutOfBlocks,
                                      RadixPrefixIndex)
from repro_torch.serve.workload import (Request, shared_prefix_trace,
                                        synthetic_trace)

LOGIT_TOL = 3e-2
CACHE_TOL = 6e-2
ROOT = os.path.join(os.path.dirname(__file__), "..")
ENGINE_YAML = os.path.join(ROOT, "examples", "configs", "serve_engine.yaml")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are reduced: their ops are far too small to split
    across threads, and under the suite's parallel workers, which share the
    host's cores, torch's default of one thread per core leaves each op
    waiting on descheduled threads.  One thread for this module, restored
    after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def qwen():
    """Reduced Qwen in both packages on the same params (JAX's init, with
    random non-zero QKV biases so the bias path counts)."""
    cfg = jax_get_reduced("qwen1p5_0p5b")
    jm = jax_build_model(cfg)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(10)
    attn = params["blocks"]["attn"]
    for name in ("bq", "bk", "bv"):
        attn[name] = (0.1 * rng.standard_normal(attn[name].shape)
                      ).astype(np.float32)
    return {"cfg": cfg, "jm": jm,
            "jp": jax.tree_util.tree_map(jnp.asarray, params),
            "model": build_model(get_reduced("qwen1p5_0p5b")),
            "params": params_from_jax(params)}


# ---------------------------------------------------------------------------
# host-side bookkeeping (tests/test_serve_paging.py:40-90 on the port's copy)
# ---------------------------------------------------------------------------
def test_block_allocator_refcounts():
    a = BlockAllocator(4)
    b0 = a.alloc(2)
    assert a.n_free == 2 and a.n_used == 2
    a.retain(b0[0])                       # a sharer appears
    a.release(b0)                         # original holder retires
    assert a.n_free == 3                  # b0[1] freed, b0[0] still shared
    a.release(b0[0])
    assert a.n_free == 4
    a.check()
    with pytest.raises(OutOfBlocks):
        a.alloc(5)
    with pytest.raises(ValueError):
        a.release(b0[0])                  # double free
    # the same LIFO reuse order as JAX's allocator
    j = JaxBlockAllocator(4)
    assert a.alloc(3) == j.alloc(3)


def test_radix_match_insert_evict():
    a = BlockAllocator(8)
    idx = RadixPrefixIndex(2, a)          # 2-token pages
    blocks = a.alloc(3)
    idx.insert([1, 2, 3, 4, 5, 6], blocks)
    assert idx.n_nodes == 3 and all(a.ref[b] == 2 for b in blocks)
    assert [n.block for n in idx.match([1, 2, 3, 4, 9, 9])] == blocks[:2]
    assert [n.block for n in idx.match([1, 2, 3, 4, 5, 6], 4)] == blocks[:2]
    assert idx.match([7, 7, 7, 7]) == []
    dup = a.alloc(1)                      # existing nodes win
    idx.insert([1, 2], dup)
    assert idx.n_nodes == 3 and a.ref[dup[0]] == 1
    a.release(dup)
    a.release(blocks)                     # the "request" retires
    idx.match([1, 2])                     # touch the root page: now MRU
    assert idx.evict(a.n_free + 2) == 2 and idx.n_nodes == 1
    assert [n.block for n in idx.match([1, 2])] == [blocks[0]]
    idx.evict(8)
    assert idx.n_nodes == 0 and a.n_free == 8
    a.check()


# ---------------------------------------------------------------------------
# the determinism contract, with prefix sharing (port only, ==)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["greedy", "mixed"])
def test_paged_engine_shared_prefix_matches_solo(qwen, mode):
    """Mixed continuous batching over a prefix-heavy trace == each request
    alone in a fresh engine of the same pool shape: the slot/co-resident
    gate and the cache-hit == cold-prefill gate at once."""
    model, params = qwen["model"], qwen["params"]
    max_len = 48
    trace = shared_prefix_trace(6, model.cfg.vocab, prefix_len=16,
                                n_prefixes=1, seed=7, prompt_lens=(4, 8),
                                gen_tokens=(4, 6),
                                temperature=0.7 if mode == "mixed" else 0.0,
                                top_k=12, top_p=0.9, max_len=max_len)
    if mode == "mixed":
        trace[1].temperature = 0.0        # greedy and sampled in flight
    kw = dict(n_slots=2, max_len=max_len, block_len=8, prefill_chunk=8,
              greedy=mode == "greedy")
    res = ServeEngine(model, params, **kw).run(trace, realtime=False)
    assert res["completed"] == len(trace)
    cached = [r["cached_tokens"] for r in res["requests"]]
    assert cached[0] == 0 and all(c == 16 for c in cached[1:])
    solo = ServeEngine(model, params, **kw)
    for r, row in zip(trace, res["requests"]):
        alone = solo.run([r], realtime=False, warmup=False)["requests"][0]
        assert alone["cached_tokens"] == 0
        assert alone["gen_ids"] == row["gen_ids"], r.rid


@pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "sampled"])
def test_prefix_cache_off_is_bitwise_identical(qwen, temperature):
    model, params = qwen["model"], qwen["params"]
    trace = shared_prefix_trace(5, model.cfg.vocab, prefix_len=16, seed=3,
                                prompt_lens=(4, 8), gen_tokens=(4,),
                                temperature=temperature, top_k=8, max_len=48)
    kw = dict(n_slots=2, max_len=48, block_len=8, prefill_chunk=16)
    on = ServeEngine(model, params, **kw).run(trace, realtime=False)
    off = ServeEngine(model, params, prefix_cache=False, **kw).run(
        trace, realtime=False)
    assert on["prefill_cache_hit_rate"] > 0
    assert off["prefill_cache_hit_rate"] == 0
    assert ([r["gen_ids"] for r in on["requests"]]
            == [r["gen_ids"] for r in off["requests"]])


def test_refcount_eviction_under_slot_churn(qwen):
    model, params = qwen["model"], qwen["params"]
    trace = synthetic_trace(8, model.cfg.vocab, seed=5, prompt_lens=(10, 14),
                            gen_tokens=(4,), max_len=32)
    engine = ServeEngine(model, params, n_slots=2, max_len=32, block_len=8,
                         prefill_chunk=8, n_blocks=6)
    res = engine.run(trace, realtime=False)
    assert res["completed"] == 8
    pg = res["paging"]
    assert pg["evictions"] > 0
    assert pg["free_blocks"] + pg["cached_blocks"] == pg["n_blocks"]
    engine._alloc.check()
    held = [n.block for n in engine._radix._nodes]
    assert len(set(held)) == len(held)
    assert all(engine._alloc.ref[b] == 1 for b in held)


def test_chunked_prefill_interleaves_decode(qwen):
    """A 33-token cold admission is 5 chunks with a decode tick between
    them, so the mid-decode co-resident advances during the prefill — and
    both streams are still the solo streams."""
    model, params = qwen["model"], qwen["params"]
    short = Request(rid=0, prompt=np.arange(3, 9, dtype=np.int32),
                    max_new=10, seed=1, temperature=0.8, top_k=16)
    long = Request(rid=1, prompt=np.asarray(
        np.random.default_rng(2).integers(3, model.cfg.vocab, 33), np.int32),
        max_new=4, seed=2, temperature=0.8, top_k=16)
    kw = dict(n_slots=2, max_len=48, block_len=8, prefill_chunk=8,
              prefix_cache=False)
    res = ServeEngine(model, params, **kw).run([short, long], realtime=False)
    assert res["interleaved_decode_ticks"] >= 4
    solo = ServeEngine(model, params, **kw)
    for r, row in zip((short, long), res["requests"]):
        alone = solo.run([r], realtime=False, warmup=False)["requests"][0]
        assert alone["gen_ids"] == row["gen_ids"]


# ---------------------------------------------------------------------------
# configuration edges
# ---------------------------------------------------------------------------
def test_paged_rejected_for_windowed_and_ssm_archs():
    for arch, overrides in [("stablelm_1p6b", {"window": 8}),
                            ("mamba2_780m", {})]:
        model = build_model(get_reduced(arch).with_(**overrides))
        params = load_params(model, device="cpu")
        assert not model.supports_paged_cache()
        with pytest.raises(EngineError):
            ServeEngine(model, params, n_slots=2, max_len=16, block_len=8)
        engine = ServeEngine(model, params, n_slots=2, max_len=16)
        assert not engine.paged           # auto: the dense slot pool
        trace = synthetic_trace(2, model.cfg.vocab, seed=1, prompt_lens=(4,),
                                gen_tokens=(3,), temperature=0.8,
                                max_len=16)
        assert engine.run(trace, realtime=False)["completed"] == 2


def test_paged_knob_validation(qwen):
    model, params = qwen["model"], qwen["params"]
    with pytest.raises(EngineError):      # chunk off the block grid
        ServeEngine(model, params, n_slots=2, max_len=32, block_len=8,
                    prefill_chunk=12)
    with pytest.raises(EngineError):      # pool cannot hold one request
        ServeEngine(model, params, n_slots=2, max_len=32, block_len=8,
                    n_blocks=3)
    # a pool that holds one request at a time serves the trace in turn
    engine = ServeEngine(model, params, n_slots=2, max_len=32, block_len=8,
                         n_blocks=4, prefill_chunk=8)
    trace = synthetic_trace(3, model.cfg.vocab, seed=2, prompt_lens=(10,),
                            gen_tokens=(4,), max_len=32)
    assert engine.run(trace, realtime=False)["completed"] == 3


def test_serve_settings_paged_knobs():
    from repro_torch.run.config import RunError, parse_run_doc

    doc = {
        "run": {"kind": "serve", "name": "p",
                "serve": {"engine": True, "n_slots": 2, "block_len": 8,
                          "n_blocks": 24, "prefill_chunk": 16,
                          "prefix_cache": False,
                          "workload": {"n_requests": 4, "prefix_len": 24,
                                       "n_prefixes": 2,
                                       "prompt_lens": [4, 8],
                                       "gen_tokens": 4}}},
        "arch": {"component_key": "arch_config", "variant_key": "qwen1p5_0p5b",
                 "config": {"reduced": True}},
    }
    s = parse_run_doc(doc).settings
    assert (s.block_len, s.n_blocks, s.prefill_chunk) == (8, 24, 16)
    assert not s.prefix_cache and s.workload.gen_tokens == [4]
    assert s.workload.prefix_len == 24 and s.workload.n_prefixes == 2
    for bad in ({"block_len": -2}, {"workload": {"prefix_len": -1}},
                {"deadline_s": -1.0}, {"sampling": {"top_k": -1}},
                {"workload": {"nope": 1}}):
        with pytest.raises(RunError):
            parse_run_doc({"run": {"kind": "serve", "serve": bad}})


# ---------------------------------------------------------------------------
# parity with JAX's paged engine
# ---------------------------------------------------------------------------
def _jax_paged_logits(qwen, prompt, gen, bl, C, max_len):
    """JAX's logits for the token after ``prompt + gen``, teacher-forced
    through its paged programs: the prompt in C-token chunks into pages
    0.., then one decode step per token of ``gen``."""
    jm, jp = qwen["jm"], qwen["jp"]
    chunk, step = jax.jit(jm.prefill_chunk), jax.jit(jm.decode_step)
    max_pages = -(-max_len // bl)
    cache = jm.init_paged_cache(max_pages, bl)
    row = jnp.arange(max_pages, dtype=jnp.int32)
    P = len(prompt)
    for lo in range(0, P, C):
        toks = np.zeros((C,), np.int32)
        toks[:min(C, P - lo)] = prompt[lo:lo + C]
        logits, cache = chunk(jp, cache, row, jnp.asarray(toks),
                              jnp.int32(lo), jnp.int32(min(C, P - lo)))
    for j, tok in enumerate(gen):
        logits, cache = step(
            jp, cache, jnp.asarray([tok], jnp.int32),
            jnp.asarray([P + j], jnp.int32), pages=row[None],
            active=jnp.asarray([True]))
    return np.asarray(logits, np.float32)[0]


def _parts_at_a_near_tie(qwen, r, i, port_tok, bl, C, max_len):
    """JAX's sampler draws ``port_tok`` once each of JAX's logits moves by
    at most LOGIT_TOL: down for the tokens that beat it, up for the rest."""
    logits = _jax_paged_logits(qwen, r.prompt, r.jax_stream[:i], bl, C,
                               max_len)
    key = jax.random.fold_in(jax.random.PRNGKey(r.seed), i)[None]
    if r.temperature > 0:
        score = logits / r.temperature + np.asarray(
            jax.random.gumbel(key[0], logits.shape))
    else:
        score = logits
    delta = np.where(score > score[port_tok], -LOGIT_TOL, LOGIT_TOL)
    tok = jax_sample_tokens(
        jnp.asarray(logits + delta)[None], key,
        jnp.float32([r.temperature]), jnp.int32([r.top_k]),
        jnp.float32([r.top_p]))
    return int(tok[0]) == port_tok


@pytest.mark.parametrize("temperature", [0.0, 0.7], ids=["greedy", "sampled"])
def test_paged_engine_streams_match_jax_or_tie(qwen, temperature):
    """Both packages' paged engines on one prefix-heavy trace (2 slots, so
    admissions interleave with ticks, a slot is reused and prefixes hit):
    the same cache hits, and each stream equal to JAX's or parted at a
    near-tie."""
    cfg = qwen["cfg"]
    kw = dict(n_prefixes=2, prefix_len=16, seed=7, prompt_lens=(4, 8),
              gen_tokens=(6,), temperature=temperature, top_k=12, top_p=0.9,
              max_len=48)
    eng = dict(n_slots=2, max_len=48, block_len=8, prefill_chunk=8,
               greedy=temperature == 0)
    jout = JaxServeEngine(qwen["jm"], qwen["jp"], **eng).run(
        jax_shared_prefix_trace(6, cfg.vocab, **kw), realtime=False)
    trace = shared_prefix_trace(6, cfg.vocab, **kw)
    pout = ServeEngine(qwen["model"], qwen["params"], **eng).run(
        trace, realtime=False)
    assert set(pout) == set(jout) | {"tpot_ms"}
    assert pout["prefill_cache_hit_rate"] == jout["prefill_cache_hit_rate"] > 0
    same = 0
    for r, prow, jrow in zip(trace, pout["requests"], jout["requests"]):
        assert prow["cached_tokens"] == jrow["cached_tokens"]
        a, b = prow["gen_ids"], jrow["gen_ids"]
        assert len(a) == len(b) == 6
        if a == b:
            same += 1
            continue
        i = next(j for j in range(6) if a[j] != b[j])
        r.jax_stream = b
        assert _parts_at_a_near_tie(qwen, r, i, a[i], 8, 8, 48), (r.rid, i)
    assert same >= 4


def test_paged_cache_after_one_admission_matches_jax(qwen):
    """One 21-token prompt in chunks of 16 into pages [3, 0, 5]: the pool's
    n_blocks pages equal JAX's within the bf16 cache tolerance, the pages
    the request does not name stay zero, and the logits of its last row
    match."""
    n_blocks, bl, C = 6, 8, 16
    prompt = np.random.default_rng(5).integers(3, qwen["cfg"].vocab, 21,
                                               dtype=np.int32)
    row = np.array([3, 0, 5, -1], np.int32)
    jm, jp = qwen["jm"], qwen["jp"]
    jcache = jm.init_paged_cache(n_blocks, bl)
    model, params = qwen["model"], qwen["params"]
    pcache = model.init_paged_cache(n_blocks, bl, device="cpu")
    for lo in (0, 16):
        n = min(C, 21 - lo)
        toks = np.zeros((C,), np.int32)
        toks[:n] = prompt[lo:lo + n]
        jl, jcache = jm.prefill_chunk(jp, jcache, jnp.asarray(row),
                                      jnp.asarray(toks), jnp.int32(lo),
                                      jnp.int32(n))
        pl, pcache = model.prefill_chunk(params, pcache, torch.as_tensor(row),
                                         torch.as_tensor(toks, dtype=torch.int64),
                                         lo, n)
    np.testing.assert_allclose(pl.float().numpy(), np.asarray(jl, np.float32),
                               atol=LOGIT_TOL, rtol=0)
    got = params_to_numpy(pcache)["blocks"]
    for name in ("k", "v"):
        want = np.asarray(jcache["blocks"][name], np.float32)
        assert got[name].shape[1] == n_blocks + 1      # + the scratch block
        np.testing.assert_allclose(got[name][:, :n_blocks], want,
                                   atol=CACHE_TOL, rtol=0)
        assert not got[name][:, [1, 2, 4]].any()
        assert np.abs(want[:, [3, 0, 5]]).max() > 0.1


def _layer(qwen):
    """Layer 0's attention params in both packages, and a pool of random
    finite K/V (5 blocks of 8, K=2 heads of 64) with its port copy holding
    one more block, the scratch."""
    jparams = jax.tree_util.tree_map(lambda a: a[0],
                                     qwen["jp"]["blocks"]["attn"])
    pparams = {k: v[0] for k, v in qwen["params"]["blocks"]["attn"].items()}
    rng = np.random.default_rng(8)
    kv = {n: rng.standard_normal((5, 8, 2, 64)).astype(np.float32)
          for n in ("k", "v")}
    jcache = {n: jnp.asarray(a, jnp.bfloat16) for n, a in kv.items()}
    pcache = {n: torch.cat([torch.from_numpy(a),
                            torch.zeros((1, 8, 2, 64))]).to(torch.bfloat16)
              for n, a in kv.items()}
    return jparams, pparams, jcache, pcache


def _x(rows, seed):
    x = np.random.default_rng(seed).standard_normal((*rows, 256)) * 0.5
    return (jnp.asarray(x, jnp.bfloat16),
            torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16))


def _same_pool(pcache, jcache):
    for n in ("k", "v"):
        assert torch.equal(pcache[n][:5].float(),
                           torch.from_numpy(np.asarray(jcache[n], np.float32)))


@pytest.mark.parametrize("case", ["inactive_slot", "retired_at_max_len"])
def test_decode_out_of_range_indices_match_jax(qwen, case):
    """Where JAX's scatter drops a write (an inactive slot) and its gather
    clamps a page index (a retired slot's frozen pos == max_len, so
    pos // bl == max_pages), the port raises nothing, its first n_blocks
    pages equal JAX's bit for bit, and every output row matches."""
    cfg = qwen["cfg"]
    jparams, pparams, jcache, pcache = _layer(qwen)
    pages = np.array([[1, 3, -1], [4, 0, 2]], np.int32)    # max_len 24
    pos = {"inactive_slot": [9, 13], "retired_at_max_len": [9, 24]}[case]
    pos = np.array(pos, np.int32)
    active = np.array([True, False])
    jx, px = _x((2, 1), 1)
    jout, jcache = jax.jit(functools.partial(JA.gqa_decode_paged, cfg))(
        jparams, jcache, jx,
        jnp.asarray(pos), jnp.asarray(pages), jnp.asarray(active))
    pout, pcache = PA.gqa_decode_paged(cfg, pparams, pcache, px,
                                       torch.as_tensor(pos),
                                       torch.as_tensor(pages),
                                       torch.as_tensor(active))
    np.testing.assert_allclose(pout.float().numpy(),
                               np.asarray(jout, np.float32),
                               atol=LOGIT_TOL, rtol=0)
    # the live slot wrote one row (bf16 projections of each package); the
    # inactive slot wrote nothing into the n_blocks pages
    jk = np.asarray(jcache["k"], np.float32)
    pk = pcache["k"][:5].float().numpy()
    live = (pages[0, pos[0] // 8], pos[0] % 8)
    np.testing.assert_allclose(pk[live], jk[live], atol=CACHE_TOL, rtol=0)
    pk[live] = jk[live]
    assert np.array_equal(pk, jk)


def test_chunk_padding_past_the_page_table_matches_jax(qwen):
    """A chunk whose padding rows run past the page table (start 16, 16
    rows, 3 valid, 3 pages of 8: rows at 24..31 index page 3 of 3): no
    error, the valid rows' outputs as JAX's, and the pool's n_blocks pages
    JAX's bit for bit but for the three rows written."""
    cfg = qwen["cfg"]
    jparams, pparams, jcache, pcache = _layer(qwen)
    row = np.array([2, 4, 1], np.int32)
    positions = np.arange(16, 32, dtype=np.int32)
    jx, px = _x((1, 16), 2)
    jout, jcache = jax.jit(functools.partial(JA.gqa_prefill_chunk, cfg))(
        jparams, jcache, jx, jnp.asarray(positions), jnp.asarray(row),
        jnp.int32(3))
    pout, pcache = PA.gqa_prefill_chunk(cfg, pparams, pcache, px,
                                        torch.as_tensor(positions),
                                        torch.as_tensor(row), 3)
    np.testing.assert_allclose(pout[:, :3].float().numpy(),
                               np.asarray(jout[:, :3], np.float32),
                               atol=LOGIT_TOL, rtol=0)
    written = (np.array([1, 1, 1]), np.arange(3))   # positions 16..18
    for name in ("k", "v"):
        jk = np.asarray(jcache[name], np.float32)
        pk = pcache[name][:5].float().numpy()
        np.testing.assert_allclose(pk[written], jk[written], atol=CACHE_TOL,
                                   rtol=0)
        pk[written] = jk[written]
        assert np.array_equal(pk, jk)


# ---------------------------------------------------------------------------
# deadlines, the watchdog, telemetry
# ---------------------------------------------------------------------------
def _slow_ticks(engine, seconds):
    """Make every decode tick of ``engine`` take ``seconds`` longer."""
    import time

    tick = engine._tick

    def slow(*args):
        time.sleep(seconds)
        return tick(*args)

    engine._tick = slow
    return engine


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_deadlines_retire_queued_and_in_flight_requests(qwen, paged):
    """A queued request past its deadline retires unserved; an admitted one
    retires mid-decode with the tokens it has; a request without a deadline
    completes; the slot and its pages are reused cleanly after."""
    model, params = qwen["model"], qwen["params"]
    trace = synthetic_trace(3, model.cfg.vocab, seed=3, prompt_lens=(6,),
                            gen_tokens=(10,), temperature=0.8, max_len=24)
    trace[0].deadline_s = 0.12            # in flight: ~3 slow ticks
    trace[1].deadline_s = 1e-9            # queued: expires before admission
    engine = _slow_ticks(ServeEngine(model, params, n_slots=1, max_len=24,
                                     block_len=8 if paged else 0), 0.04)
    res = engine.run(trace, realtime=False)
    rows = {r["id"]: r for r in res["requests"]}
    assert rows[0]["finish"] == "timeout" and 1 <= rows[0]["n_gen"] < 10
    assert rows[1]["finish"] == "timeout" and rows[1]["gen_ids"] == []
    assert rows[2]["finish"] == "length" and rows[2]["n_gen"] == 10
    assert res["timeouts"] == 2 and res["completed"] == 1
    # the third request's stream is its solo stream: the timed-out one left
    # nothing behind in the slot
    solo = ServeEngine(model, params, n_slots=1, max_len=24,
                       block_len=8 if paged else 0)
    assert solo.run([trace[2]], realtime=False)["requests"][0]["gen_ids"] \
        == rows[2]["gen_ids"]
    if paged:
        engine._alloc.check()


def test_engine_deadline_and_zero_deadline(qwen):
    """The engine-wide deadline applies to every request; 0 means none."""
    model, params = qwen["model"], qwen["params"]
    trace = synthetic_trace(2, model.cfg.vocab, seed=3, prompt_lens=(6,),
                            gen_tokens=(4,), max_len=16)
    res = ServeEngine(model, params, n_slots=1, max_len=16).run(
        trace, realtime=False)
    assert res["timeouts"] == 0 and res["completed"] == 2
    res = ServeEngine(model, params, n_slots=1, max_len=16,
                      deadline_s=1e-9).run(trace, realtime=False)
    assert res["timeouts"] == 2 and res["completed"] == 0
    with pytest.raises(EngineError, match=">= 0"):
        ServeEngine(model, params, n_slots=1, max_len=16, deadline_s=-1)


def test_watchdog_trips_on_a_stalled_tick(qwen):
    model, params = qwen["model"], qwen["params"]
    trace = synthetic_trace(1, model.cfg.vocab, seed=3, prompt_lens=(6,),
                            gen_tokens=(4,), max_len=16)
    engine = _slow_ticks(ServeEngine(model, params, n_slots=1, max_len=16,
                                     watchdog_s=0.1), 0.25)
    with pytest.raises(EngineError, match="watchdog"):
        engine.run(trace, realtime=False)
    # the same engine without the stall stays under its watchdog
    fast = ServeEngine(model, params, n_slots=1, max_len=16, watchdog_s=5.0)
    assert fast.run(trace, realtime=False)["completed"] == 1


def test_request_spans_and_summary_metric(qwen):
    """Every retired request gives one serve/request span with its queued,
    prefill and decode children; one serve_summary metric row a run."""
    from repro_torch.telemetry import ListSink, TelemetryRecorder

    model, params = qwen["model"], qwen["params"]
    rec = TelemetryRecorder(ListSink(), run="t", kind="serve")
    trace = shared_prefix_trace(3, model.cfg.vocab, prefix_len=16, seed=1,
                                prompt_lens=(4,), gen_tokens=(3,), max_len=32)
    res = ServeEngine(model, params, n_slots=2, max_len=32, block_len=8,
                      telemetry=rec).run(trace, realtime=False)
    spans = [r for r in rec.rows if r["type"] == "span"]
    roots = [s for s in spans if s["name"] == "serve/request"]
    assert len(roots) == 3
    for root in roots:
        kids = {s["name"]: s for s in spans
                if s["parent_id"] == root["span_id"]}
        assert set(kids) == {"serve/queued", "serve/prefill", "serve/decode"}
        assert kids["serve/prefill"]["attrs"]["cached_tokens"] in (0, 16)
    summary = [r for r in rec.rows if r["type"] == "metric"]
    assert len(summary) == 1
    assert summary[0]["attrs"]["phase"] == "serve_summary"
    assert summary[0]["data"]["completed"] == res["completed"] == 3


# ---------------------------------------------------------------------------
# the run API on the unchanged engine document
# ---------------------------------------------------------------------------
def test_execute_serve_engine_document_writes_bench_under_output_dir(
        tmp_path, monkeypatch):
    """``examples/configs/serve_engine.yaml`` unchanged but for its output
    directory: 12 of 12 requests, the same per-request cached tokens and
    hit rate as JAX's run of the same document, ``BENCH_serve_quickstart
    .json`` with the key set of the JAX package's tracked artifact in the
    output directory, and nothing in the working directory."""
    from repro.run import api as jax_api
    from repro_torch.run import api

    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    doc = load_yaml(ENGINE_YAML)
    doc["run"]["output_dir"] = str(tmp_path / "run")
    res = api.execute_doc(doc, device="cpu", write_result=True,
                          log=lambda m: None)
    ref = jax_api.execute_doc(load_yaml(ENGINE_YAML), write_files=False)
    assert res["completed"] == ref["completed"] == 12
    assert res["prefill_cache_hit_rate"] == ref["prefill_cache_hit_rate"] > 0
    assert ([r["cached_tokens"] for r in res["requests"]]
            == [r["cached_tokens"] for r in ref["requests"]])
    bench = tmp_path / "run" / "BENCH_serve_quickstart.json"
    assert res["bench_file"] == str(bench)
    with open(os.path.join(ROOT, "BENCH_serve_quickstart.json")) as f:
        tracked = json.load(f)
    b = json.loads(bench.read_text())
    assert set(b) == set(tracked)
    for key in ("paging", "static_shim", "telemetry", "ttft_hit_s"):
        assert set(b[key]) == set(tracked[key]), key
    assert b["fingerprint"].startswith("sha256:")
    assert (tmp_path / "run" / "result.json").exists()
    assert list(cwd.iterdir()) == []
    if not torch.cuda.is_available():
        with pytest.raises(NoDeviceError):
            api.execute_doc(load_yaml(ENGINE_YAML), log=lambda m: None)
