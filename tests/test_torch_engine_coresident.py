"""A request that times out in flight leaves a co-resident's pages alone
(ROADMAP C1), on the port's paged engine on the CPU.

The JAX package's engine breaks this guarantee.  Its in-flight deadline
retires the request on the host (``repro/serve/engine.py``) and sets the
slot's page row to -1, but leaves ``slots["active"]`` true on the device:
the slot keeps decoding, and ``gqa_decode_paged`` writes its K/V to block
-1, which ``_paged_write`` wraps to block ``n_blocks - 1``, a block another
request may hold.  With the inputs below (ticks slowed by 0.05 s, JAX 0.9.0
on the CPU) request A times out after 13 tokens while B holds blocks 6-13;
B's K rows at positions 56-62 (block 13) then differ from B's solo run by
up to 4.66, and B's stream parts from its solo stream at token index 24
(239 against 352).

The port clears the slot's ``active`` flag on timeout, and its pool has a
scratch block past ``n_blocks`` that takes suppressed writes, so B's stream
is its solo stream, ``==``.
"""
import time

import jax
import numpy as np

from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.workload import Request

ENGINE = dict(n_slots=2, max_len=64, block_len=8, prefill_chunk=8,
              n_blocks=14, greedy=True)
TICK_DELAY_S = 0.05


def test_timed_out_request_leaves_a_co_residents_pages_alone():
    """A (6 tokens, 40 to generate, deadline 0.6 s) times out while B (35
    tokens, 29 to generate) is resident and holds the pool's last block;
    B's stream equals B's stream alone in a fresh engine."""
    cfg = jax_get_reduced("qwen1p5_0p5b")
    params = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jax_build_model(cfg).init(jax.random.PRNGKey(0))))
    model = build_model(get_reduced("qwen1p5_0p5b"))
    rng = np.random.default_rng(5)
    a = Request(rid=0, prompt=rng.integers(3, 500, 6).astype(np.int32),
                max_new=40, deadline_s=0.6)
    b = Request(rid=1, prompt=rng.integers(3, 500, 35).astype(np.int32),
                max_new=29)

    engine = ServeEngine(model, params, **ENGINE)
    tick = engine._tick
    held = []           # B's blocks at every tick it was resident for

    def slow_tick(*args):
        time.sleep(TICK_DELAY_S)
        blocks = getattr(engine, "_req_blocks", {}).get(b.rid)  # (warm-up:
        if blocks:                                               # no table)
            held.append(list(blocks))
        return tick(*args)

    engine._tick = slow_tick
    res = engine.run([a, b], realtime=False)
    rows = {r["id"]: r for r in res["requests"]}
    ra, rb = rows[a.rid], rows[b.rid]
    assert ra["finish"] == "timeout" and 1 <= ra["n_gen"] < a.max_new
    assert rb["finish"] == "length" and rb["n_gen"] == b.max_new
    # B was admitted (first token out) before A timed out, and ran on after
    assert rb["ttft_s"] < ra["done_s"] < rb["done_s"]
    assert held and all(blocks == held[0] for blocks in held)
    assert max(held[0]) == ENGINE["n_blocks"] - 1
    assert res["timeouts"] == 1 and res["completed"] == 1
    engine._alloc.check()

    solo = ServeEngine(model, params, **ENGINE).run([b], realtime=False)
    assert solo["requests"][0]["gen_ids"] == rb["gen_ids"]
