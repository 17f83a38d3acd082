"""The port's engines on DeepSeek-V3's latent cache against the JAX
package's, on the CPU.

Reduced ``deepseek_v3_671b`` (MLA, 1 dense + 1 MoE layer, MTP unused at
serving time) on JAX's params, carried across by ``repro_torch.bridge``;
traces from both packages' seeded numpy workloads.  Two kinds of check, as
``tests/test_torch_engine.py``:

- the determinism contract inside the port, with ``==``: a request's stream
  does not depend on its slot or co-residents, on whether its prefix was a
  cache hit or a cold prefill, or on ``prefix_cache``, with the expanded
  and the absorbed decode;
- parity with JAX.  Serving is bf16 end to end and each package rounds at
  its own places, so streams are equal or part at a near-tie: at the first
  differing token, moving each of JAX's logits (teacher-forced through
  JAX's own programs) by at most ``LOGIT_TOL`` = 3e-2 makes JAX's sampler
  draw the port's token (the rule and bound of ``tests/test_torch_engine.py``;
  for greedy streams, JAX's top-2 margin is within ``LOGIT_TOL``, as
  ``tests/test_torch_serve.py``).  Of the 15 streams here, one parts so
  (ROADMAP C2).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.sampling import sample_tokens as jax_sample_tokens
from repro.serve.workload import shared_prefix_trace as jax_shared_prefix_trace
from repro.serve.workload import static_trace as jax_static_trace
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.run.cli import main as cli_main
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.workload import shared_prefix_trace, static_trace

ARCH = "deepseek_v3_671b"
LOGIT_TOL = 3e-2
ENGINE_YAML = os.path.join(os.path.dirname(__file__), "..", "examples",
                           "configs", "serve_engine.yaml")
PAGED = dict(n_slots=2, max_len=48, block_len=8, prefill_chunk=8)
TRACE = dict(n_prefixes=2, prefix_len=16, seed=7, prompt_lens=(4, 8),
             gen_tokens=(6,), temperature=0.7, top_k=12, top_p=0.9,
             max_len=48)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Reduced models: their ops are far too small to split across threads,
    and the suite's parallel workers share the host's cores.  One thread
    for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def ds():
    jcfg = jax_get_reduced(ARCH)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0)))
    return {"jcfg": jcfg, "params": params,
            "jp": jax.tree_util.tree_map(jnp.asarray, params),
            "pp": params_from_jax(params)}


def _models(ds, absorb):
    return (jax_build_model(ds["jcfg"].with_(mla_absorb=absorb)),
            build_model(get_reduced(ARCH).with_(mla_absorb=absorb)))


# ---------------------------------------------------------------------------
# the dense engine (the static shim's pool)
# ---------------------------------------------------------------------------
def test_dense_engine_greedy_streams_match_jax_or_tie(ds):
    """Three 12-token prompts over two slots (one slot reused), 6 greedy
    tokens each, on both packages' dense latent pools: each stream equals
    JAX's, or at the first differing token JAX's own top-2 margin
    (teacher-forced along JAX's stream) is a bf16 tie."""
    jm, pm = _models(ds, False)
    prompts = np.random.default_rng(4).integers(3, 512, size=(3, 12),
                                                dtype=np.int32)
    kw = dict(n_slots=2, max_len=20, greedy=True, block_len=0)
    jout = JaxServeEngine(jm, ds["jp"], **kw).run(
        jax_static_trace(prompts, 6), realtime=False)
    pout = ServeEngine(pm, ds["pp"], **kw).run(static_trace(prompts, 6),
                                               realtime=False)
    assert pout["completed"] == 3 and pout["generated_tokens"] == 18
    for r, (prow, jrow) in enumerate(zip(pout["requests"], jout["requests"])):
        a, b = prow["gen_ids"], jrow["gen_ids"]
        assert len(a) == len(b) == 6
        if a == b:
            continue
        i = next(j for j in range(6) if a[j] != b[j])
        logits, cache = jm.prefill(ds["jp"], {"tokens": jnp.asarray(
            prompts[r:r + 1])}, max_len=20)
        for j in range(i):
            logits, cache = jm.decode_step(ds["jp"], cache,
                                           jnp.asarray([b[j]]),
                                           jnp.asarray([12 + j]))
        top2 = np.sort(_np(logits[0]))[-2:]
        assert top2[1] - top2[0] <= LOGIT_TOL, (r, i)


# ---------------------------------------------------------------------------
# the paged engine
# ---------------------------------------------------------------------------
def _jax_paged_logits(jm, jp, prompt, gen, bl, C, max_len):
    """JAX's logits for the token after ``prompt + gen``, teacher-forced
    through its paged programs."""
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
        logits, cache = step(jp, cache, jnp.asarray([tok], jnp.int32),
                             jnp.asarray([P + j], jnp.int32), pages=row[None],
                             active=jnp.asarray([True]))
    return _np(logits)[0]


def _parts_at_a_near_tie(jm, jp, r, i, port_tok, jax_stream):
    logits = _jax_paged_logits(jm, jp, r.prompt, jax_stream[:i], 8, 8, 48)
    key = jax.random.fold_in(jax.random.PRNGKey(r.seed), i)[None]
    score = logits / r.temperature + np.asarray(
        jax.random.gumbel(key[0], logits.shape))
    delta = np.where(score > score[port_tok], -LOGIT_TOL, LOGIT_TOL)
    tok = jax_sample_tokens(
        jnp.asarray(logits + delta)[None], key, jnp.float32([r.temperature]),
        jnp.int32([r.top_k]), jnp.float32([r.top_p]))
    return int(tok[0]) == port_tok


@pytest.mark.parametrize("absorb", [False, True], ids=["expanded", "absorb"])
def test_paged_engine_streams_match_jax_or_tie(ds, absorb):
    """Both packages' paged engines (2 slots, latent pages of 8, chunk 8)
    on one prefix-heavy sampled trace, with the expanded (JAX's default)
    and the absorbed decode: the same cache hits, and each stream equal to
    JAX's or parted at a near-tie."""
    jm, pm = _models(ds, absorb)
    jout = JaxServeEngine(jm, ds["jp"], **PAGED).run(
        jax_shared_prefix_trace(6, 512, **TRACE), realtime=False)
    trace = shared_prefix_trace(6, 512, **TRACE)
    pout = ServeEngine(pm, ds["pp"], **PAGED).run(trace, realtime=False)
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
        assert _parts_at_a_near_tie(jm, ds["jp"], r, i, a[i], b), (r.rid, i)
    assert same >= 4


@pytest.mark.parametrize("absorb", [False, True], ids=["expanded", "absorb"])
def test_paged_engine_shared_prefix_matches_solo(ds, absorb):
    """Mixed continuous batching over a prefix-heavy trace (greedy and
    sampled in flight) == each request alone in a fresh engine of the same
    pool shape: the slot/co-resident gate and the cache-hit == cold-prefill
    gate at once, on latent pages."""
    _, pm = _models(ds, absorb)
    trace = shared_prefix_trace(6, 512, prefix_len=16, n_prefixes=1, seed=7,
                                prompt_lens=(4, 8), gen_tokens=(4, 6),
                                temperature=0.7, top_k=12, top_p=0.9,
                                max_len=48)
    trace[1].temperature = 0.0
    res = ServeEngine(pm, ds["pp"], **PAGED).run(trace, realtime=False)
    assert res["completed"] == len(trace)
    cached = [r["cached_tokens"] for r in res["requests"]]
    assert cached[0] == 0 and all(c == 16 for c in cached[1:])
    solo = ServeEngine(pm, ds["pp"], **PAGED)
    for r, row in zip(trace, res["requests"]):
        alone = solo.run([r], realtime=False, warmup=False)["requests"][0]
        assert alone["cached_tokens"] == 0
        assert alone["gen_ids"] == row["gen_ids"], r.rid


def test_prefix_cache_off_is_bitwise_identical(ds):
    _, pm = _models(ds, False)
    trace = shared_prefix_trace(5, 512, prefix_len=16, seed=3,
                                prompt_lens=(4, 8), gen_tokens=(4,),
                                temperature=0.9, top_k=8, max_len=48)
    kw = dict(n_slots=2, max_len=48, block_len=8, prefill_chunk=16)
    on = ServeEngine(pm, ds["pp"], **kw).run(trace, realtime=False)
    off = ServeEngine(pm, ds["pp"], prefix_cache=False, **kw).run(
        trace, realtime=False)
    assert on["prefill_cache_hit_rate"] > 0
    assert off["prefill_cache_hit_rate"] == 0
    assert ([r["gen_ids"] for r in on["requests"]]
            == [r["gen_ids"] for r in off["requests"]])


def test_cli_runs_the_engine_document(tmp_path, capsys):
    """``python -m repro_torch serve`` on ``serve_engine.yaml`` (paged)
    with ``arch.variant_key=deepseek_v3_671b``, reduced: every request
    completes through the latent pages."""
    rc = cli_main(["serve", "--config", ENGINE_YAML, "--device", "cpu",
                   "--set", f"arch.variant_key={ARCH}",
                   "--set", f"run.output_dir={tmp_path / 'out'}"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "done: 12/12 requests" in out
