"""The Zamba2 hybrid through the port's serving engine and run API, against
the JAX package, on the CPU.

Reduced zamba2_2p7b (two Mamba2 layers, one shared attention block used
twice) with JAX's params carried across by ``repro_torch.bridge``.  A
hybrid has no paged cache in either package (its SSM state has no token
axis): it takes the dense slot pool, whose rows carry the ``ssm_blocks``
state and the ``shared_attn`` K/V.

- The determinism contract inside the port, with ``==``: a request's
  stream does not depend on its co-residents, admission order or slot
  (the zamba2 case of ``tests/test_serve_engine.py::test_engine_matches_solo``).
- Parity with JAX's engine: each stream equals JAX's or parts at a
  near-tie.  At the first differing token, moving each of JAX's logits
  (teacher-forced through JAX's prefill and decode) by at most
  ``LOGIT_TOL`` = 3e-2 (the bf16 logit bound of
  ``tests/test_torch_hybrid.py``) makes JAX's own sampler draw the port's
  token.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.sampling import sample_tokens as jax_sample_tokens
from repro.serve.workload import synthetic_trace as jax_synthetic_trace
from repro_torch.bridge import params_from_jax
from repro_torch.config.resolver import load_yaml
from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.run import api
from repro_torch.run.overrides import apply_overrides, parse_overrides
from repro_torch.serve.engine import EngineError, ServeEngine
from repro_torch.serve.workload import synthetic_trace

ARCH = "zamba2_2p7b"
LOGIT_TOL = 3e-2
MAX_LEN = 32
TRACE = dict(seed=11, rate=0.0, prompt_lens=(6, 10), gen_tokens=(3, 6),
             temperature=0.8, top_k=16, top_p=0.95, max_len=MAX_LEN)


@pytest.fixture(scope="module")
def hybrid():
    """Reduced Zamba2 in both packages on JAX's params, and one mixed
    greedy/sampled trace of 5 requests over 2 slots through both engines."""
    cfg = jax_get_reduced(ARCH)
    jm = jax_build_model(cfg)
    np_params = jax.tree_util.tree_map(np.asarray,
                                       jm.init(jax.random.PRNGKey(0)))
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    model = build_model(get_reduced(ARCH))
    params = params_from_jax(np_params)
    trace = synthetic_trace(5, cfg.vocab, **TRACE)
    trace[0].temperature = 0.0            # greedy and sampled mixed in-flight
    jtrace = jax_synthetic_trace(5, cfg.vocab, **TRACE)
    jtrace[0].temperature = 0.0
    res = ServeEngine(model, params, n_slots=2, max_len=MAX_LEN).run(
        trace, realtime=False)
    jres = JaxServeEngine(jm, jp, n_slots=2, max_len=MAX_LEN).run(
        jtrace, realtime=False)
    return {"cfg": cfg, "jm": jm, "jp": jp, "model": model, "params": params,
            "trace": trace, "res": res, "jres": jres}


def test_engine_matches_solo(hybrid):
    """Every request's stream from the mixed run equals its stream alone
    in a pool of the same shape."""
    res, trace = hybrid["res"], hybrid["trace"]
    assert res["completed"] == len(trace)
    streams = {r["id"]: r["gen_ids"] for r in res["requests"]}
    solo = ServeEngine(hybrid["model"], hybrid["params"], n_slots=2,
                       max_len=MAX_LEN)
    for r in trace:
        assert solo.run([r], realtime=False)["requests"][0]["gen_ids"] \
            == streams[r.rid], r.rid


def _jax_logits(hybrid, prompt, gen):
    """JAX's logits for generation index ``len(gen)``: the prefill, then one
    decode step per token of ``gen``."""
    jm, jp = hybrid["jm"], hybrid["jp"]
    P = len(prompt)
    logits, cache = jm.prefill(jp, {"tokens": jnp.asarray(prompt)[None]},
                               max_len=MAX_LEN)
    for j, tok in enumerate(gen):
        logits, cache = jm.decode_step(jp, cache, jnp.asarray([tok], jnp.int32),
                                       jnp.asarray([P + j], jnp.int32))
    return np.asarray(logits, np.float32)[0]


def test_engine_streams_match_jax_engine_or_tie(hybrid):
    """Both packages' dense engines on the same trace: each stream equal to
    JAX's, or parted where JAX's sampler, its logits moved by at most
    ``LOGIT_TOL`` (down for the tokens that beat the port's, up for the
    rest), draws the port's token."""
    same = 0
    for r, prow, jrow in zip(hybrid["trace"], hybrid["res"]["requests"],
                             hybrid["jres"]["requests"]):
        a, b = prow["gen_ids"], jrow["gen_ids"]
        assert len(a) == len(b) == r.max_new
        if a == b:
            same += 1
            continue
        i = next(j for j in range(len(a)) if a[j] != b[j])
        logits = _jax_logits(hybrid, r.prompt, b[:i])
        key = jax.random.fold_in(jax.random.PRNGKey(r.seed), i)[None]
        score = logits
        if r.temperature > 0:
            score = logits / r.temperature + np.asarray(
                jax.random.gumbel(key[0], logits.shape))
        delta = np.where(score > score[a[i]], -LOGIT_TOL, LOGIT_TOL)
        tok = jax_sample_tokens(
            jnp.asarray(logits + delta)[None], key,
            jnp.float32([r.temperature]), jnp.int32([r.top_k]),
            jnp.float32([r.top_p]))
        assert int(tok[0]) == a[i], (r.rid, i)
    assert same >= 3


def test_paged_rejected_and_auto_falls_back_to_dense(hybrid):
    """The zamba2 case of ``tests/test_serve_paging.py::
    test_paged_rejected_for_windowed_and_ssm_archs``."""
    model, params = hybrid["model"], hybrid["params"]
    assert not model.supports_paged_cache()
    with pytest.raises(EngineError):
        ServeEngine(model, params, n_slots=2, max_len=16, block_len=8)
    engine = ServeEngine(model, params, n_slots=2, max_len=16)
    assert not engine.paged
    trace = synthetic_trace(2, model.cfg.vocab, seed=1, prompt_lens=(4,),
                            gen_tokens=(3,), max_len=16)
    assert engine.run(trace, realtime=False)["completed"] == 2


# ---------------------------------------------------------------------------
# the run API: serve (shim and engine) and train with the hybrid
# ---------------------------------------------------------------------------
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "examples", "configs")
HYBRID_SETS = ["arch.variant_key=zamba2_2p7b",
               "arch.config.use_flash_kernel=true"]


def _doc(name, *sets):
    doc = load_yaml(os.path.join(CONFIGS, f"{name}.yaml"))
    return apply_overrides(doc, parse_overrides(list(sets)))


def test_serve_kind_runs_the_hybrid_shim_and_engine(tmp_path):
    """``serve.yaml`` (the static shim) and ``serve_engine.yaml`` with the
    hybrid: the engine document's pages (``block_len: 8``) are refused as
    in JAX, and with ``block_len: -1`` (auto) it serves every request on
    the dense pool.  The SSD scan needs each prompt to be a multiple of
    ``min(chunk, P)`` in both packages, so the engine trace takes prompts
    of 16 and 32 tokens with no shared prefix (32 + 8 would not divide)."""
    shim = api.execute_doc(_doc("serve", *HYBRID_SETS, "run.serve.gen=4",
                                "run.serve.batch=2"), device="cpu",
                           log=lambda m: None)
    assert shim["arch"] == "zamba2-2.7b-reduced"
    assert [len(ids) for ids in shim["generated_ids"]] == [4, 4]
    sets = [*HYBRID_SETS, "run.serve.workload.n_requests=4",
            "run.serve.workload.prefix_len=0",
            "run.serve.workload.prompt_lens=[16, 32]",
            "run.serve.workload.realtime=false",
            "run.serve.compare_static=false",
            f"run.output_dir={tmp_path / 'run'}"]
    with pytest.raises(EngineError):
        api.execute_doc(_doc("serve_engine", *sets), device="cpu",
                        log=lambda m: None)
    res = api.execute_doc(_doc("serve_engine", *sets,
                               "run.serve.block_len=-1"),
                          device="cpu", log=lambda m: None)
    assert res["completed"] == res["n_requests"] == 4
    assert "paging" not in res


def test_train_kind_trains_the_hybrid(tmp_path):
    """``quickstart.yaml`` with the hybrid and the flash kernel: three
    steps through the gym, finite losses."""
    res = api.execute_doc(_doc("quickstart", *HYBRID_SETS,
                               "run.train.steps=3",
                               f"dataset.config.prefix={tmp_path / 'qs'}"),
                          device="cpu", log=lambda m: None)
    losses = [h["loss"] for h in res["history"]]
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
