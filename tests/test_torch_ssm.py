"""The port's Mamba2 (SSM) slice against the JAX package, on the CPU.

Reduced mamba2_780m (2 layers, d_model 256, 16 SSD heads of 32, state 16,
chunk 32) with JAX's params carried across by ``repro_torch.bridge``;
inputs are made with numpy from a seed.  The port's SSD wrapper runs its
plain version here (the tensors lie on the CPU); the JAX side runs its Pallas
kernel in interpret mode, as ``tests/test_kernels.py`` does, or
``ssd_chunked`` where the model calls it.

Tolerances:

- f32 scan and layer (``F32_TOL``, 1e-5 of the largest output element, as
  an absolute bound): both packages compute the same f32 expression; only
  the order of the einsums' sums over a chunk (Q <= 64 terms) and over the
  state (N terms) differs, whose f32 rounding stays near 1e-6 of their size.
- the kernel cases keep the JAX kernel test's bounds: 3e-5 * max|ref| in
  f32 and 3e-2 * max|ref| in bf16 (y rounded once to bf16, a step of 2**-8
  relative, on top of each package's own bf16 rounding of the inputs).
- the served model runs in bf16 (``LOGIT_TOL`` 3e-2, ``STATE_TOL``):
  activations, the conv sums and y are bf16, rounded at other places by
  XLA (which may keep a fused chain in f32) and by eager PyTorch (which
  rounds every op).  Logits here are about 1 in size, where a bf16 step is
  2**-7 = 0.0078, and the two differ by one to two steps after two
  layers (0.0137 at most here).  The f32 decode state (``STATE_TOL``, of its
  largest element) sums bf16 inputs that differ by a bf16 step between the
  packages: 1.7e-2 of its largest element here, held to 5e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.ssm as JS
import repro_torch.models.ssm as PS
from repro.configs import get_reduced as jax_get_reduced
from repro.kernels.ssd.ops import ssd as jax_ssd
from repro.kernels.ssd.ref import ssd_recurrence_ref as jax_recurrence
from repro.models import build_model as jax_build_model
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.workload import static_trace as jax_static_trace
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_reduced
from repro_torch.kernels.ssd import ops
from repro_torch.kernels.ssd.ref import ssd_chunked, ssd_recurrence_ref
from repro_torch.models import build_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.workload import static_trace
from test_kernels import SSD_CASES

ARCH = "mamba2_780m"
F32_TOL = 1e-5
LOGIT_TOL = 3e-2
STATE_TOL = 5e-2
P, G = 64, 6          # prompt (two chunks of 32), generated tokens

_TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _np(x):
    return np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel):
    """|got - want| <= rel * max|want|, elementwise."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _scan_inputs(B, S, H, Pd, Gr, N, seed=0):
    """Numpy inputs of the SSD scan: x, dt (post-softplus), A < 0, B, C, D."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    return (f(B, S, H, Pd), np.log1p(np.exp(f(B, S, H))),
            -np.exp(0.5 * f(H)), 0.3 * f(B, S, Gr, N), 0.3 * f(B, S, Gr, N),
            1.0 + 0.1 * f(H))


# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_jax(with_h0):
    x, dt, A, Bm, Cm, D = _scan_inputs(2, 96, 4, 16, 2, 8)
    h0 = (np.random.default_rng(1).standard_normal((2, 4, 16, 8), dtype=np.float32)
          if with_h0 else None)
    jy, jh = JS.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm, D)),
                            chunk=32, h0=None if h0 is None else jnp.asarray(h0))
    py, ph = ssd_chunked(*map(_t, (x, dt, A, Bm, Cm, D)), chunk=32,
                         h0=None if h0 is None else _t(h0))
    assert py.dtype == torch.float32 and ph.shape == (2, 4, 16, 8)
    _close(py, jy, F32_TOL)
    _close(ph, jh, F32_TOL)


def _ssd_id(c):
    return f"B{c[0]}S{c[1]}H{c[2]}P{c[3]}G{c[4]}N{c[5]}c{c[6]}{c[7].__name__}"


@pytest.mark.parametrize("case", SSD_CASES, ids=_ssd_id)
def test_ssd_scan_cpu_route_matches_jax_kernel(case):
    """``ops.ssd_scan`` on CPU tensors (its plain version) against the Pallas
    kernel in interpret mode; its final state against JAX's ``ssd_chunked``."""
    B, S, H, Pd, Gr, N, chunk, dt_ = case
    x, dt, A, Bm, Cm, D = _scan_inputs(B, S, H, Pd, Gr, N, seed=2)
    jx, jB, jC = (jnp.asarray(a).astype(dt_) for a in (x, Bm, Cm))
    jargs = (jx, jnp.asarray(dt), jnp.asarray(A), jB, jC, jnp.asarray(D))
    want = jax_ssd(*jargs, chunk=chunk)
    _, want_h = JS.ssd_chunked(*jargs, chunk=chunk)
    tdt = _TORCH_DTYPE[dt_]
    before = ops.launches
    got, got_h = ops.ssd_scan(_t(x).to(tdt), _t(dt), _t(A), _t(Bm).to(tdt),
                              _t(Cm).to(tdt), _t(D), chunk=chunk)
    assert ops.launches == before          # the CPU never counts a launch
    assert got.dtype == tdt and got.shape == (B, S, H, Pd)
    _close(got.float(), want, 3e-2 if dt_ == jnp.bfloat16 else 3e-5)
    _close(got_h, want_h, 3e-5)


def test_ssd_recurrence_ref_matches_jax():
    x, dt, A, Bm, Cm, D = _scan_inputs(1, 40, 4, 8, 2, 8, seed=3)
    want = jax_recurrence(*map(jnp.asarray, (x, dt, A, Bm, Cm, D)))
    got = ssd_recurrence_ref(*map(_t, (x, dt, A, Bm, Cm, D)))
    _close(got, want, F32_TOL)
    # and the chunked scan is the recurrence
    y, _ = ssd_chunked(*map(_t, (x, dt, A, Bm, Cm, D)), chunk=8)
    _close(y, want, F32_TOL)


def test_ssd_scan_refuses_on_the_cpu_what_the_card_would():
    x, dt, A, Bm, Cm, D = map(_t, _scan_inputs(1, 40, 4, 8, 2, 8))
    with pytest.raises(ValueError, match="divisible"):
        ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=16)
    with pytest.raises(TypeError, match="dtype"):
        ops.ssd_scan(x.half(), dt, A, Bm.half(), Cm.half(), D, chunk=8)
    with pytest.raises(TypeError, match="float32"):
        ops.ssd_scan(x, dt.double(), A, Bm, Cm, D, chunk=8)
    with pytest.raises(ValueError, match="groups"):
        ops.ssd_scan(x, dt, A, Bm[:, :, :1].expand(1, 40, 3, 8), Cm[:, :, :1]
                     .expand(1, 40, 3, 8), D, chunk=8)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------
def _cfgs():
    return jax_get_reduced(ARCH), get_reduced(ARCH)


@pytest.fixture(scope="module")
def ssm_params():
    """One layer's SSM params from JAX's init, with a non-zero conv bias and
    D so those terms count."""
    jcfg, _ = _cfgs()
    p = jax.tree_util.tree_map(np.asarray, JS.init_ssm(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    p["conv_b"] = (0.1 * rng.standard_normal(p["conv_b"].shape)).astype(np.float32)
    p["D"] = (1.0 + 0.2 * rng.standard_normal(p["D"].shape)).astype(np.float32)
    return p


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def test_causal_conv_matches_jax():
    x, w, b = _x((2, 12, 40)), _x((4, 40), 2), _x((40,), 3)
    want = JS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = PS._causal_conv(_t(x), _t(w), _t(b))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6, rtol=1e-6)


def test_softplus_is_jax_softplus_above_the_threshold():
    v = np.array([-30.0, -1.0, 0.0, 3.0, 19.0, 21.0, 40.0], np.float32)
    np.testing.assert_array_equal(PS._softplus(_t(v)).numpy(),
                                  _np(jax.nn.softplus(jnp.asarray(v))))


def test_ssm_forward_with_state_matches_jax(ssm_params):
    jcfg, pcfg = _cfgs()
    x = _x((2, 64, jcfg.d_model), 4)
    want, wst = JS.ssm_forward(jcfg, jax.tree_util.tree_map(jnp.asarray, ssm_params),
                               jnp.asarray(x), return_state=True)
    got, gst = PS.ssm_forward(pcfg, params_from_jax(ssm_params), _t(x),
                              return_state=True)
    _close(got, want, F32_TOL)
    assert gst["conv"].dtype == gst["ssm"].dtype == torch.float32
    for k in ("conv", "ssm"):
        assert tuple(gst[k].shape) == tuple(wst[k].shape)
        _close(gst[k], wst[k], F32_TOL)


def test_ssm_decode_matches_jax(ssm_params):
    """Three steps from a random state, the port's state updated in place."""
    jcfg, pcfg = _cfgs()
    st = jax.tree_util.tree_map(np.asarray, JS.ssm_init_state(jcfg, 2))
    st = {k: _x(v.shape, 5 + i) for i, (k, v) in enumerate(st.items())}
    jst = jax.tree_util.tree_map(jnp.asarray, st)
    pst = params_from_jax(st)
    held = pst["ssm"]
    jp = jax.tree_util.tree_map(jnp.asarray, ssm_params)
    pp = params_from_jax(ssm_params)
    for i in range(3):
        x = _x((2, 1, jcfg.d_model), 10 + i)
        want, jst = JS.ssm_decode(jcfg, jp, jst, jnp.asarray(x))
        got, pst = PS.ssm_decode(pcfg, pp, pst, _t(x))
        _close(got, want, F32_TOL)
        for k in ("conv", "ssm"):
            _close(pst[k], jst[k], F32_TOL)
    assert pst["ssm"] is held


def test_ssm_init_state_is_f32_whatever_the_cache_dtype():
    _, pcfg = _cfgs()
    st = PS.ssm_init_state(pcfg, 3, dtype=torch.bfloat16)
    assert st["ssm"].dtype == torch.float32 and st["conv"].dtype == torch.bfloat16
    assert tuple(st["ssm"].shape) == (3, 16, 32, 16)
    assert tuple(st["conv"].shape) == (3, 3, 544)


def test_init_ssm_matches_jax_tree_and_ranges():
    """Seeded torch init cannot give JAX's numbers; it gives its tree, its
    shapes and its laws: A in [1, 16), dt_bias the inverse softplus of
    [1e-3, 0.1), unit D and norm, zero conv bias."""
    jcfg, pcfg = _cfgs()
    jshapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape),
        jax.eval_shape(lambda r: JS.init_ssm(jcfg, r), jax.random.PRNGKey(0)))
    p = PS.init_ssm(pcfg, torch.Generator().manual_seed(0), lead=(3,))
    assert {k: tuple(v.shape[1:]) for k, v in p.items()} == jshapes
    A = torch.exp(p["A_log"])
    assert float(A.min()) >= 1.0 and float(A.max()) < 16.0
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert float(dt.min()) >= 1e-3 - 1e-7 and float(dt.max()) < 0.1 + 1e-7
    assert bool((p["D"] == 1).all() and (p["norm"] == 1).all()
                and (p["conv_b"] == 0).all())


# ---------------------------------------------------------------------------
# the served model
# ---------------------------------------------------------------------------
def _jax_params(cfg, seed=0):
    params = jax.tree_util.tree_map(
        np.asarray, jax_build_model(cfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 10)
    blk = params["ssm_blocks"]["ssm"]
    blk["conv_b"] = (0.1 * rng.standard_normal(blk["conv_b"].shape)).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def ref():
    """JAX prefill + teacher-forced greedy decode of reduced mamba2."""
    cfg, _ = _cfgs()
    model = jax_build_model(cfg)
    params = _jax_params(cfg)
    prompt = np.random.default_rng(1).integers(3, cfg.vocab, size=(1, P),
                                               dtype=np.int32)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    logits, cache = jax.jit(lambda p, t: model.prefill(
        p, {"tokens": t}, max_len=P + G))(jp, jnp.asarray(prompt))
    out = {"params": params, "prompt": prompt, "prefill_logits": _np(logits),
           "cache": jax.tree_util.tree_map(_np, cache)}
    step = jax.jit(model.decode_step)
    tokens, step_logits = [], []
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    for i in range(3):
        tokens.append(int(tok[0]))
        logits, cache = step(jp, cache, tok, jnp.asarray([P + i], jnp.int32))
        step_logits.append(_np(logits))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    out["tokens"], out["step_logits"] = tokens, step_logits
    out["final_cache"] = jax.tree_util.tree_map(_np, cache)
    return out


@pytest.fixture(scope="module")
def port(ref):
    _, cfg = _cfgs()
    model = build_model(cfg)
    params = params_from_jax(ref["params"])
    logits, cache = model.prefill(params, {"tokens": torch.as_tensor(
        ref["prompt"], dtype=torch.int64)}, max_len=P + G)
    out = {"prefill_logits": _np(logits.float()), "cache": params_to_numpy(cache)}
    step_logits = []
    for i, tok in enumerate(ref["tokens"]):
        logits, cache = model.decode_step(
            params, cache, torch.tensor([tok], dtype=torch.int32),
            torch.tensor([P + i]))
        step_logits.append(_np(logits.float()))
    out["step_logits"] = step_logits
    out["final_cache"] = params_to_numpy(cache)
    return out


def test_prefill_logits_match_jax(ref, port):
    assert port["prefill_logits"].shape == (1, 512)
    np.testing.assert_allclose(port["prefill_logits"], ref["prefill_logits"],
                               atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("which", ["cache", "final_cache"])
def test_decode_state_matches_jax(ref, port, which):
    """The prefill's decode-ready state, and the state after three decode
    steps, under the ``ssm_blocks`` key as in JAX."""
    got, want = port[which]["ssm_blocks"], ref[which]["ssm_blocks"]
    assert set(port[which]) == set(ref[which]) == {"ssm_blocks"}
    for k in ("conv", "ssm"):
        assert got[k].shape == want[k].shape
        _close(got[k], want[k], STATE_TOL)
    assert got["ssm"].shape == (2, 1, 16, 32, 16)


def test_teacher_forced_decode_logits_match_jax(ref, port):
    for a, b in zip(port["step_logits"], ref["step_logits"]):
        np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=0)


@pytest.fixture(scope="module")
def engines():
    """Three requests over two slots (one slot reused) through both
    packages' dense engines, the same params and prompts."""
    cfg, pcfg = _cfgs()
    params = _jax_params(cfg, seed=3)
    prompts = np.random.default_rng(4).integers(3, cfg.vocab, size=(3, 16),
                                                dtype=np.int32)
    jeng = JaxServeEngine(jax_build_model(cfg),
                          jax.tree_util.tree_map(jnp.asarray, params),
                          n_slots=2, max_len=24, greedy=True, block_len=0)
    jout = jeng.run(jax_static_trace(prompts, 6), realtime=False)
    peng = ServeEngine(build_model(pcfg), params_from_jax(params), n_slots=2,
                       max_len=24, greedy=True, block_len=0)
    pout = peng.run(static_trace(prompts, 6), realtime=False)
    return {"cfg": cfg, "params": params, "prompts": prompts, "jax": jout,
            "port": pout}


def test_engine_streams_match_jax_engine_or_tie(engines):
    """Each stream equals JAX's engine's up to its first differing token;
    there, JAX's own logits (teacher-forced along JAX's stream) have a top-2
    margin within the logit tolerance: an argmax tie in bf16."""
    assert engines["port"]["completed"] == 3
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
            jp, {"tokens": jnp.asarray(engines["prompts"][r:r + 1])}, max_len=24)
        for j in range(i):
            logits, cache = jm.decode_step(jp, cache, jnp.asarray([b[j]]),
                                           jnp.asarray([16 + j]))
        top2 = np.sort(_np(logits[0]))[-2:]
        assert top2[1] - top2[0] <= LOGIT_TOL, (r, i)


def test_engine_pool_keeps_ssm_state_per_slot(engines):
    """The slot pool holds one f32 (conv, ssm) state per slot and layer, as
    JAX's ``init_cache`` makes it."""
    cfg, pcfg = _cfgs()
    want = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)),
        jax_build_model(cfg).init_cache(2, 24))
    got = build_model(pcfg).init_cache(2, 24, device="cpu")
    got = {n: {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
               for k, v in t.items()} for n, t in got.items()}
    assert got == want


def test_bridge_round_trip_of_an_ssm_tree():
    """JAX params -> port -> numpy gives JAX's arrays back bit for bit, and
    the port's own init makes JAX's tree."""
    cfg, pcfg = _cfgs()
    params = _jax_params(cfg, seed=5)
    back = params_to_numpy(params_from_jax(params))
    assert set(back["ssm_blocks"]["ssm"]) == {
        "in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm",
        "out_proj"}
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)
    mine = build_model(pcfg).init(torch.Generator().manual_seed(0))
    shapes = lambda t: jax.tree_util.tree_map(lambda a: tuple(a.shape), t)  # noqa: E731
    assert shapes(params_to_numpy(mine)) == shapes(params)


@pytest.mark.parametrize("arch", ["whisper_tiny"])
def test_build_model_still_refuses_unported_archs(arch):
    """Every arch type of the repo builds now; an arch type the repo does
    not have is refused, and ``DecoderLM`` refuses the encoder-decoder."""
    from repro_torch.models.transformer import DecoderLM

    with pytest.raises(NotImplementedError, match="no such model"):
        build_model(get_reduced(arch).with_(arch_type="retnet"))
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        DecoderLM(get_reduced(arch))


def test_bridge_snapshot_does_not_follow_in_place_updates():
    """``params_to_numpy`` copies: a decode step that updates the f32 state in
    place leaves an earlier snapshot as it was."""
    _, pcfg = _cfgs()
    cache = build_model(pcfg).init_cache(1, 8, device="cpu")
    snap = params_to_numpy(cache)
    cache["ssm_blocks"]["ssm"].add_(1.0)
    assert not snap["ssm_blocks"]["ssm"].any()
