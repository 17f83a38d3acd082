"""The port's serving slice against the JAX package, on the CPU.

Reduced qwen1.5-0.5b (QKV bias, tied embeddings) with JAX's params carried
across by ``repro_torch.bridge``; prompts are made with numpy from a seed.
The JAX side runs its Pallas flash kernel in interpret mode, the port its
kernel's plain version (the tensors lie on the CPU).

Tolerances, bf16 end to end as the serving path runs: activations, caches
and logits are bf16, so each package rounds at its own places (the Pallas
kernel returns its f32 softmax-weighted sum cast to bf16; the einsums
accumulate in another order).  Logits here are about 1 in size, where a
bf16 step is 2**-7 = 0.0078; the two packages differ by one or two such
steps after two layers, so logits are held to atol 3e-2 (four steps) and
the bf16 K/V cache (values of a few units, steps of 2**-6 to 2**-5) to atol
6e-2.  Greedy tokens are compared teacher-forced or tie-aware: a top-2
margin of one bf16 step does occur on these random weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.launch.serve import serve_benchmark as jax_serve_benchmark
from repro.models import build_model as jax_build_model
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.workload import static_trace as jax_static_trace
from repro.serve.workload import synthetic_trace as jax_synthetic_trace
from repro.serve.workload import trace_summary as jax_trace_summary
from repro.train.steps import make_serve_step as jax_make_serve_step
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_reduced
from repro_torch.device import NoDeviceError
from repro_torch.launch.serve import serve_benchmark
from repro_torch.models import build_model
from repro_torch.serve.engine import EngineError, ServeEngine, load_params
from repro_torch.serve.workload import static_trace, synthetic_trace, trace_summary
from repro_torch.train.steps import make_serve_step

P, G = 32, 8
LOGIT_TOL = 3e-2
CACHE_TOL = 6e-2


def _jax_params(cfg, seed=0):
    """JAX's init, with random (non-zero) QKV biases so the bias path counts."""
    params = jax.tree_util.tree_map(
        np.asarray, jax_build_model(cfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 10)
    attn = params["blocks"]["attn"]
    for name in ("bq", "bk", "bv"):
        attn[name] = (0.1 * rng.standard_normal(attn[name].shape)).astype(np.float32)
    return params


def _f32(x):
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def ref():
    """JAX prefill + teacher-forced greedy decode, with the flash kernel."""
    cfg = jax_get_reduced("qwen1p5_0p5b").with_(use_flash_kernel=True)
    model = jax_build_model(cfg)
    params = _jax_params(cfg)
    prompt = np.random.default_rng(1).integers(3, cfg.vocab, size=(1, P),
                                               dtype=np.int32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    prefill = jax.jit(lambda p, t: model.prefill(p, {"tokens": t},
                                                 max_len=P + G))
    logits, cache = prefill(jp, jnp.asarray(prompt))
    out = {"cfg": cfg, "params": params, "prompt": prompt,
           "prefill_logits": _f32(logits),
           "cache": jax.tree_util.tree_map(_f32, cache)}
    step = jax.jit(model.decode_step)
    tokens, step_logits = [], []
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    for i in range(G - 1):
        tokens.append(int(tok[0]))
        logits, cache = step(jp, cache, tok, jnp.asarray([P + i], jnp.int32))
        step_logits.append(_f32(logits))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    out["tokens"] = tokens
    out["step_logits"] = step_logits
    return out


@pytest.fixture(scope="module")
def port(ref):
    """The port on the same params and prompt: prefill + decode fed JAX's
    token stream (teacher-forced, so one argmax tie cannot derail the rest)."""
    from repro_torch.kernels.flash import ops

    cfg = get_reduced("qwen1p5_0p5b").with_(use_flash_kernel=True)
    model = build_model(cfg)
    params = params_from_jax(ref["params"])
    launches = ops.launches
    logits, cache = model.prefill(params, {"tokens": torch.as_tensor(
        ref["prompt"], dtype=torch.int64)}, max_len=P + G)
    out = {"prefill_logits": _f32(logits.float()),
           "cache": params_to_numpy(cache), "launches": ops.launches - launches}
    step_logits = []
    for i, tok in enumerate(ref["tokens"]):
        logits, cache = model.decode_step(
            params, cache, torch.tensor([tok], dtype=torch.int32),
            torch.tensor([P + i], dtype=torch.int64))
        step_logits.append(_f32(logits.float()))
    out["step_logits"] = step_logits
    return out


def test_prefill_logits_match_jax(ref, port):
    assert port["prefill_logits"].shape == (1, ref["cfg"].vocab)
    np.testing.assert_allclose(port["prefill_logits"], ref["prefill_logits"],
                               atol=LOGIT_TOL, rtol=0)


def test_prefill_cache_matches_jax(ref, port):
    for name in ("k", "v"):
        a = port["cache"]["blocks"][name]
        b = ref["cache"]["blocks"][name]
        assert a.shape == b.shape == (2, 1, P + G, 2, 64)
        np.testing.assert_allclose(a, b, atol=CACHE_TOL, rtol=0)
        assert not a[:, :, P:].any()          # padded to max_len with zeros


def test_prefill_goes_through_flash_wrapper_without_launching(port):
    # on the CPU the wrapper runs the plain version and never counts a launch
    assert port["launches"] == 0


def test_teacher_forced_decode_logits_match_jax(ref, port):
    assert len(port["step_logits"]) == G - 1
    for a, b in zip(port["step_logits"], ref["step_logits"]):
        np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=0)


def test_greedy_tokens_match_or_tie(ref, port):
    """Where the port's greedy token differs from JAX's, JAX's own top-2
    margin lies within the logit tolerance (an argmax tie in bf16)."""
    port_first = int(np.argmax(port["prefill_logits"][0]))
    pairs = [(port_first, ref["prefill_logits"][0])]
    pairs += [(int(np.argmax(a[0])), b[0])
              for a, b in zip(port["step_logits"], ref["step_logits"])]
    for tok, jl in pairs:
        if tok != int(np.argmax(jl)):
            top2 = np.sort(jl)[-2:]
            assert top2[1] - top2[0] <= LOGIT_TOL


@pytest.fixture(scope="module")
def engines():
    """Three requests over two slots (so one slot is reused) through both
    packages' dense engines, plain attention, the same params and prompts."""
    cfg = jax_get_reduced("qwen1p5_0p5b")
    params = _jax_params(cfg, seed=3)
    prompts = np.random.default_rng(4).integers(3, cfg.vocab, size=(3, 12),
                                                dtype=np.int32)
    jeng = JaxServeEngine(jax_build_model(cfg),
                          jax.tree_util.tree_map(jnp.asarray, params),
                          n_slots=2, max_len=20, greedy=True, block_len=0)
    jout = jeng.run(jax_static_trace(prompts, 6), realtime=False)
    model = build_model(get_reduced("qwen1p5_0p5b"))
    tparams = params_from_jax(params)
    peng = ServeEngine(model, tparams, n_slots=2, max_len=20, greedy=True,
                       block_len=0)
    pout = peng.run(static_trace(prompts, 6), realtime=False)
    return {"cfg": cfg, "params": params, "prompts": prompts, "jax": jout,
            "port": pout, "model": model, "tparams": tparams}


def test_engine_streams_match_solo_decode(engines):
    """Slot pool, in-place admission and batched ticks change nothing: each
    request's stream equals its own batch=1 prefill + decode in the port."""
    model, params = engines["model"], engines["tparams"]
    pout = engines["port"]
    assert pout["completed"] == 3 and pout["generated_tokens"] == 18
    for r, row in enumerate(pout["requests"]):
        prompt = torch.as_tensor(engines["prompts"][r:r + 1], dtype=torch.int64)
        logits, cache = model.prefill(params, {"tokens": prompt}, max_len=20)
        toks = [int(logits.argmax(-1))]
        for i in range(5):
            logits, cache = model.decode_step(
                params, cache, torch.tensor([toks[-1]], dtype=torch.int32),
                torch.tensor([12 + i]))
            toks.append(int(logits.argmax(-1)))
        assert row["gen_ids"] == toks


def test_engine_streams_match_jax_engine_or_tie(engines):
    """Each stream equals JAX's engine's up to its first differing token;
    there, JAX's own logits (teacher-forced along JAX's stream) have a
    top-2 margin within the logit tolerance: an argmax tie in bf16."""
    jm = jax_build_model(engines["cfg"])
    jp = jax.tree_util.tree_map(jnp.asarray, engines["params"])
    for r, (prow, jrow) in enumerate(zip(engines["port"]["requests"],
                                         engines["jax"]["requests"])):
        a, b = prow["gen_ids"], jrow["gen_ids"]
        assert len(a) == len(b) == 6
        if a == b:
            continue
        i = next(j for j in range(6) if a[j] != b[j])
        logits, cache = jm.prefill(
            jp, {"tokens": jnp.asarray(engines["prompts"][r:r + 1])}, max_len=20)
        for j in range(i):
            logits, cache = jm.decode_step(jp, cache, jnp.asarray([b[j]]),
                                           jnp.asarray([12 + j]))
        top2 = np.sort(_f32(logits[0]))[-2:]
        assert top2[1] - top2[0] <= LOGIT_TOL, (r, i)


def test_serve_step_matches_jax(ref):
    """``make_serve_step`` from JAX's prefill cache: the same greedy token
    (or a bf16 tie) and logits within the logit tolerance."""
    tok, pos = ref["tokens"][0], P
    jcache = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                    ref["cache"])
    jtok, jlogits, _ = jax_make_serve_step(jax_build_model(ref["cfg"]))(
        jax.tree_util.tree_map(jnp.asarray, ref["params"]), jcache,
        jnp.asarray([tok], jnp.int32), jnp.asarray([pos], jnp.int32))
    pcache = jax.tree_util.tree_map(lambda a: torch.from_numpy(a).to(torch.bfloat16),
                                    ref["cache"])
    model = build_model(get_reduced("qwen1p5_0p5b").with_(use_flash_kernel=True))
    ptok, plogits, _ = make_serve_step(model)(
        params_from_jax(ref["params"]), pcache, torch.tensor([tok], dtype=torch.int32),
        torch.tensor([pos]))
    jl = _f32(jlogits)
    np.testing.assert_allclose(_f32(plogits.float()), jl, atol=LOGIT_TOL, rtol=0)
    if int(ptok[0]) != int(jtok[0]):
        top2 = np.sort(jl[0])[-2:]
        assert top2[1] - top2[0] <= LOGIT_TOL


def test_engine_result_keys_match_jax(engines):
    assert set(engines["port"]) == set(engines["jax"])
    row_keys = {k for r in engines["jax"]["requests"] for k in r}
    assert {k for r in engines["port"]["requests"] for k in r} == row_keys


@pytest.mark.parametrize("rate", [0.0, 5.0])
def test_synthetic_trace_matches_jax(rate):
    kw = dict(seed=7, rate=rate, prompt_lens=(4, 9), gen_tokens=(2, 5),
              temperature=0.5, top_k=3, eos_id=2, max_len=12)
    port, ref = synthetic_trace(6, 100, **kw), jax_synthetic_trace(6, 100, **kw)
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert {k: v for k, v in vars(a).items() if k != "prompt"} == \
            {k: v for k, v in vars(b).items() if k != "prompt"}
    assert trace_summary(port) == jax_trace_summary(ref)


@pytest.fixture(scope="module")
def cpu_engine_parts():
    model = build_model(get_reduced("qwen1p5_0p5b"))
    return model, load_params(model, seed=1, device="cpu")


def test_engine_retires_on_eos(cpu_engine_parts):
    """A request whose EOS is its second greedy token stops right there."""
    model, params = cpu_engine_parts
    prompts = np.random.default_rng(5).integers(3, 512, size=(1, 6), dtype=np.int32)
    eng = ServeEngine(model, params, n_slots=1, max_len=12)
    free = eng.run(static_trace(prompts, 5), realtime=False, warmup=False)
    toks = free["requests"][0]["gen_ids"]
    assert len(toks) == 5 and free["requests"][0]["finish"] == "length"
    eos = toks[1]
    stop = next(i for i, t in enumerate(toks) if t == eos)
    out = eng.run(static_trace(prompts, 5, eos_id=eos), realtime=False,
                  warmup=False)
    row = out["requests"][0]
    assert row["finish"] == "eos" and row["gen_ids"] == toks[:stop + 1]
    assert out["completed"] == 1 and out["timeouts"] == 0


def test_engine_refuses_request_deadlines(cpu_engine_parts):
    """A request whose deadline has passed before it could be admitted
    retires unserved as a timeout; the next one is served in full."""
    model, params = cpu_engine_parts
    trace = synthetic_trace(2, 512, seed=2, prompt_lens=(6,), gen_tokens=(3,),
                            max_len=12)
    trace[0].deadline_s = 1e-9
    out = ServeEngine(model, params, n_slots=1, max_len=12).run(trace)
    rows = {r["id"]: r for r in out["requests"]}
    assert rows[0]["finish"] == "timeout" and rows[0]["gen_ids"] == []
    assert rows[1]["finish"] == "length" and rows[1]["n_gen"] == 3
    assert out["timeouts"] == 1 and out["completed"] == 1


def test_engine_step_probes_match_run(cpu_engine_parts):
    """The profiling hook runs the same admission and tick as ``run``: over a
    pool filled with one prompt, the admission gives the stream's first token
    and the tick its second, in every slot."""
    model, params = cpu_engine_parts
    prompt = np.random.default_rng(6).integers(3, 512, size=(7,), dtype=np.int32)
    eng = ServeEngine(model, params, n_slots=2, max_len=12)
    out = eng.run(static_trace(np.stack([prompt, prompt]), 3), realtime=False,
                  warmup=False)
    toks = out["requests"][0]["gen_ids"]
    assert out["requests"][1]["gen_ids"] == toks
    probes = eng.step_probes(torch.as_tensor(prompt, dtype=torch.int64))
    _, _, sampled, finished = probes["tick"]()
    assert sampled.tolist() == [toks[1]] * 2 and not finished.any()
    _, _, tok, fin = probes["admit"]()
    assert int(tok) == toks[0] and not bool(fin)


def test_engine_realtime_arrivals_queue_for_one_slot(cpu_engine_parts):
    """Poisson arrivals into one slot: each request waits for its arrival
    and for the slot, and all complete with their whole budget."""
    model, params = cpu_engine_parts
    trace = synthetic_trace(3, 512, seed=2, rate=40.0, prompt_lens=(6,),
                            gen_tokens=(3,), max_len=12)
    out = ServeEngine(model, params, n_slots=1, max_len=12).run(trace)
    assert out["completed"] == 3 and out["generated_tokens"] == 9
    for r, row in zip(trace, out["requests"]):
        assert row["arrival_s"] == r.arrival_s and row["ttft_s"] >= 0
        assert row["done_s"] >= r.arrival_s


def test_serve_benchmark_result_keys_match_jax():
    cfg = jax_get_reduced("qwen1p5_0p5b")
    jres = jax_serve_benchmark(jax_build_model(cfg), batch=2, prompt_len=8,
                               gen=3, log=lambda m: None)
    model = build_model(get_reduced("qwen1p5_0p5b"))
    res = serve_benchmark(model, batch=2, prompt_len=8, gen=3, device="cpu",
                          log=lambda m: None)
    assert set(res) == set(jres)
    assert res["gen_tokens_total"] == 6 and res["decode_tokens"] == 4
    assert all(len(ids) == 3 and all(0 <= t < cfg.vocab for t in ids)
               for ids in res["generated_ids"])


def test_entry_points_without_device_raise_on_a_host_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is the card")
    model = build_model(get_reduced("qwen1p5_0p5b"))
    with pytest.raises(NoDeviceError):
        load_params(model)
    with pytest.raises(NoDeviceError):
        serve_benchmark(model, batch=1, prompt_len=4, gen=2, log=lambda m: None)
    from repro_torch.run import api

    doc = {"run": {"kind": "serve", "serve": {"batch": 1, "prompt_len": 4,
                                               "gen": 2}},
           "arch": {"component_key": "arch_config",
                    "variant_key": "qwen1p5_0p5b", "config": {"reduced": True}}}
    with pytest.raises(NoDeviceError):
        api.execute_doc(doc, log=lambda m: None)


def test_unported_paths_raise():
    model = build_model(get_reduced("qwen1p5_0p5b"))
    params = load_params(model, device="cpu")
    with pytest.raises(NotImplementedError, match="A8"):
        ServeEngine(model, params, n_slots=1, max_len=8, mesh=object())
    with pytest.raises(NotImplementedError, match="A8"):
        ServeEngine(model, params, n_slots=1, max_len=8, plan=object())
    # the engine drives text decoders, as JAX's (``serve/engine.py``)
    for arch in ("whisper_tiny", "llava_next_34b"):
        model = build_model(get_reduced(arch))
        with pytest.raises(EngineError, match="modality extras"):
            ServeEngine(model, load_params(model, device="cpu"), n_slots=1,
                        max_len=8)
        with pytest.raises(Exception, match="modality extras"):
            JaxServeEngine(jax_build_model(jax_get_reduced(arch)), {},
                           n_slots=1, max_len=8)
