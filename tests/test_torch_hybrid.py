"""The port's Zamba2 hybrid against the JAX package, on the CPU.

Reduced zamba2_2p7b: 4 layers with ``attn_every`` 2, so two Mamba2 layers
(16 SSD heads of 32, state 16, chunk 32) and two uses of one weight-shared
attention block (4 query heads over 2 kv heads of 64, d_ff 512), with JAX's
params carried across by ``repro_torch.bridge``.  Inputs are made with
numpy from a seed.  The port's kernel wrappers run their plain versions
here (the tensors lie on the CPU); JAX runs ``ssd_chunked`` and, with
``use_flash_kernel``, its Pallas flash kernel in interpret mode.

Tolerances, stated per assertion:

- bf16 activations (the served model, and training): ``LOGIT_TOL`` 3e-2 on
  logits and ``STATE_TOL`` 5e-2 of the largest element on caches, the
  bounds of ``tests/test_torch_ssm.py`` (ROADMAP C4): XLA and eager PyTorch
  round bf16 at other places; logits here are about 1.5 in size, where a
  bf16 step is 2**-7, and the two differ by up to 0.0254 (the forward's
  2 x 64 x 512 logits at dh 80; 0.0249 at dh 64), caches by up to 2.6e-2
  of their largest element (the SSM state).
- f32 activations and caches: JAX's own decode contracts
  (``tests/test_decode_consistency.py``), 5e-4 between decode and the
  forward and 5e-3 between prefill and decode, and the same bounds between
  the packages, which differ by up to 2.5e-6 here.
- one train step: ``tests/test_torch_train.py``'s bounds (5e-2 of each
  leaf's largest gradient and 3e-3 of the loss in bf16; 1e-4 in f32).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from unittest import mock

from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro.train import steps as JST
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import build_model
from repro_torch.train import steps as PST
from repro_torch.tree import tree_leaves

ARCH = "zamba2_2p7b"
LOGIT_TOL = 3e-2
STATE_TOL = 5e-2
DECODE_FWD_TOL = 5e-4
PREFILL_DECODE_TOL = 5e-3
STEP_GRAD_TOL = 5e-2
STEP_LOSS_TOL = 3e-3
STEP_F32_TOL = 1e-4
P, G = 64, 3          # prompt (two SSD chunks of 32), decode steps


def _np(x):
    return np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel, what=""):
    """|got - want| <= rel * max|want|, elementwise."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=what)


def _jax_params(cfg, seed=0):
    """JAX's init, with a non-zero conv bias so that term counts."""
    params = jax.tree_util.tree_map(
        np.asarray, jax_build_model(cfg).init(jax.random.PRNGKey(seed)))
    blk = params["ssm_blocks"]["ssm"]
    rng = np.random.default_rng(seed + 10)
    blk["conv_b"] = (0.1 * rng.standard_normal(blk["conv_b"].shape)
                     ).astype(np.float32)
    return params


def _f32(model, module):
    """``model`` with f32 activations (``embed_tokens`` in f32)."""
    embed = model.embed_tokens
    dt = jnp.float32 if module == "jax" else torch.float32
    return mock.patch.object(model, "embed_tokens",
                             lambda p, t, dtype=None: embed(p, t, dtype=dt))


def _run_jax(cfg, params, prompt, f32=False):
    """JAX's apply logits, prefill logits and cache, three teacher-forced
    greedy decode steps and the final cache."""
    model = jax_build_model(cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    cdt = jnp.float32 if f32 else jnp.bfloat16
    with _f32(model, "jax") if f32 else contextlib.nullcontext():
        full, _ = jax.jit(model.apply)(jp, {"tokens": jnp.asarray(prompt)})
        logits, cache = jax.jit(lambda p, t: model.prefill(
            p, {"tokens": t}, max_len=P + G, cache_dtype=cdt))(
                jp, jnp.asarray(prompt))
        out = {"apply": _np(full), "prefill_logits": _np(logits),
               "cache": jax.tree_util.tree_map(_np, cache)}
        step = jax.jit(model.decode_step)
        tokens, step_logits = [], []
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        for i in range(G):
            tokens.append(np.asarray(tok))
            logits, cache = step(jp, cache, tok,
                                 jnp.full((prompt.shape[0],), P + i, jnp.int32))
            step_logits.append(_np(logits))
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    out.update(tokens=tokens, step_logits=step_logits,
               final_cache=jax.tree_util.tree_map(_np, cache))
    return out


def _run_port(cfg, params, prompt, tokens, f32=False):
    model = build_model(cfg)
    pp = params_from_jax(params)
    cdt = torch.float32 if f32 else torch.bfloat16
    tok = torch.as_tensor(prompt, dtype=torch.int64)
    with _f32(model, "port") if f32 else contextlib.nullcontext(), \
            torch.no_grad():
        full, _ = model.apply(pp, {"tokens": tok})
        logits, cache = model.prefill(pp, {"tokens": tok}, max_len=P + G,
                                      cache_dtype=cdt)
        out = {"apply": _np(full.float()),
               "prefill_logits": _np(logits.float()),
               "cache": params_to_numpy(cache)}
        step_logits = []
        for i, t in enumerate(tokens):
            logits, cache = model.decode_step(
                pp, cache, torch.as_tensor(np.array(t), dtype=torch.int32),
                torch.full((prompt.shape[0],), P + i))
            step_logits.append(_np(logits.float()))
    out.update(step_logits=step_logits, final_cache=params_to_numpy(cache))
    return out


@pytest.fixture(scope="module")
def runs():
    """Both packages on one prompt batch: bf16 (served) and f32, at the
    reduced shape (dh 64), and at dh 80 with the flash kernel on both
    sides (the only CPU check that sees dh 80 on the model path:
    ``reduce_config`` sets dh 64)."""
    prompt = np.random.default_rng(1).integers(3, 512, size=(2, P),
                                               dtype=np.int32)
    out = {"prompt": prompt}
    cases = {"bf16": (jax_get_reduced(ARCH), get_reduced(ARCH), False),
             "f32": (jax_get_reduced(ARCH), get_reduced(ARCH), True)}
    flash = dict(head_dim=80, use_flash_kernel=True)
    cases["dh80"] = (jax_get_reduced(ARCH).with_(**flash),
                     get_reduced(ARCH).with_(**flash), False)
    for name, (jcfg, pcfg, f32) in cases.items():
        params = _jax_params(jcfg)
        ref = _run_jax(jcfg, params, prompt, f32)
        out[name] = {"jax": ref, "params": params, "cfg": pcfg,
                     "port": _run_port(pcfg, params, prompt, ref["tokens"],
                                       f32)}
    return out


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------
def test_build_model_builds_the_full_width_hybrid():
    """The published config builds: 45 Mamba2 layers in one stack and one
    shared attention block of 32 heads of 80, used 9 times."""
    model = build_model(get_config(ARCH))
    assert model.kinds.count("ssm") == 45
    assert model.kinds.count("attn_block") == 9
    assert model._stacks() == [("ssm_blocks", "ssm",
                                 [i for i in range(54) if (i + 1) % 6])]
    assert model._hybrid_groups() == (9, 5)
    assert not model.supports_paged_cache()
    with pytest.raises(NotImplementedError):
        model.init_paged_cache(8, 16)


def test_params_and_cache_trees_match_jax():
    """JAX's tree and shapes: ``shared_attn`` has no layer axis; the cache
    holds one K/V row per use of the shared block."""
    jcfg = jax_get_reduced(ARCH)
    jm = jax_build_model(jcfg)
    shapes = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: tuple(a.shape), t)
    want = shapes(jax.eval_shape(jm.init, jax.random.PRNGKey(0)))
    pm = build_model(get_reduced(ARCH))
    got = shapes(params_to_numpy(pm.init(torch.Generator().manual_seed(0))))
    assert got == want
    assert got["shared_attn"]["attn"]["wq"] == (256, 4, 64)
    wc = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)),
                                jm.init_cache(3, 24))
    pc = pm.init_cache(3, 24, device="cpu")
    pc = {n: {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
              for k, v in t.items()} for n, t in pc.items()}
    assert pc == wc
    assert pc["shared_attn"]["k"][0] == (2, 3, 24, 2, 64)


# ---------------------------------------------------------------------------
# the forward, prefill and decode against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["bf16", "dh80"])
def test_apply_and_prefill_logits_match_jax(runs, case):
    """bf16 activations: within ``LOGIT_TOL`` (3e-2)."""
    port, ref = runs[case]["port"], runs[case]["jax"]
    assert port["apply"].shape == (2, P, 512)
    np.testing.assert_allclose(port["apply"], ref["apply"], atol=LOGIT_TOL,
                               rtol=0)
    np.testing.assert_allclose(port["prefill_logits"], ref["prefill_logits"],
                               atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("case", ["bf16", "dh80"])
@pytest.mark.parametrize("which", ["cache", "final_cache"])
def test_caches_match_jax(runs, case, which):
    """The prefill's decode-ready cache, and the cache after three decode
    steps: the SSM (conv, ssm) state and the shared block's K/V, within
    ``STATE_TOL`` (5e-2) of each leaf's largest element."""
    got, want = runs[case]["port"][which], runs[case]["jax"][which]
    assert set(got) == set(want) == {"ssm_blocks", "shared_attn"}
    for name in want:
        for k in want[name]:
            assert got[name][k].shape == want[name][k].shape, (name, k)
            _close(got[name][k], want[name][k], STATE_TOL, f"{name}/{k}")
    dh = runs[case]["cfg"].head_dim
    assert got["shared_attn"]["k"].shape == (2, 2, P + G, 2, dh)


@pytest.mark.parametrize("case", ["bf16", "dh80"])
def test_teacher_forced_decode_logits_match_jax(runs, case):
    for a, b in zip(runs[case]["port"]["step_logits"],
                    runs[case]["jax"]["step_logits"]):
        np.testing.assert_allclose(a, b, atol=LOGIT_TOL, rtol=0)


def test_f32_prefill_decode_and_caches_match_jax(runs):
    """f32 activations and caches: logits within 5e-4 and caches within
    5e-3 of their largest element (JAX's decode-contract bounds)."""
    port, ref = runs["f32"]["port"], runs["f32"]["jax"]
    np.testing.assert_allclose(port["apply"], ref["apply"],
                               atol=DECODE_FWD_TOL, rtol=0)
    np.testing.assert_allclose(port["prefill_logits"], ref["prefill_logits"],
                               atol=DECODE_FWD_TOL, rtol=0)
    for a, b in zip(port["step_logits"], ref["step_logits"]):
        np.testing.assert_allclose(a, b, atol=DECODE_FWD_TOL, rtol=0)
    for which in ("cache", "final_cache"):
        for name in ref[which]:
            for k in ref[which][name]:
                _close(port[which][name][k], ref[which][name][k],
                       PREFILL_DECODE_TOL, f"{which}/{name}/{k}")


# ---------------------------------------------------------------------------
# the decode contracts of tests/test_decode_consistency.py, on the port
# ---------------------------------------------------------------------------
S_DC, B_DC = 20, 2


def _contract_model(seed):
    cfg = get_reduced(ARCH)
    params = params_from_jax(_jax_params(jax_get_reduced(ARCH), seed))
    toks = torch.as_tensor(np.random.default_rng(seed + 5).integers(
        0, cfg.vocab, (B_DC, S_DC)), dtype=torch.int64)
    return build_model(cfg), params, toks


def test_decode_matches_forward():
    """Token-by-token decode from an empty f32 cache reproduces the
    teacher-forced forward's logits (f32 activations), within 5e-4."""
    model, params, toks = _contract_model(1)
    with _f32(model, "port"), torch.no_grad():
        full, _ = model.apply(params, {"tokens": toks})
        cache = model.init_cache(B_DC, S_DC, dtype=torch.float32,
                                 device="cpu")
        outs = []
        for pos in range(S_DC):
            lg, cache = model.decode_step(params, cache, toks[:, pos],
                                          torch.full((B_DC,), pos))
            outs.append(lg)
    err = float((full.float() - torch.stack(outs, 1).float()).abs().max())
    assert err < DECODE_FWD_TOL, err


def test_prefill_matches_decode_prefix():
    """The prefill's cache equals the cache of token-by-token decode: last
    logits and one continuation step from each agree within 5e-3."""
    model, params, toks = _contract_model(2)
    max_len = S_DC + 4
    with _f32(model, "port"), torch.no_grad():
        lpf, cpf = model.prefill(params, {"tokens": toks}, max_len=max_len,
                                 cache_dtype=torch.float32)
        cdec = model.init_cache(B_DC, max_len, dtype=torch.float32,
                                device="cpu")
        for pos in range(S_DC):
            ldec, cdec = model.decode_step(params, cdec, toks[:, pos],
                                           torch.full((B_DC,), pos))
        assert float((lpf - ldec).abs().max()) < PREFILL_DECODE_TOL
        nxt = torch.argmax(lpf, -1).to(torch.int32)
        l1, _ = model.decode_step(params, cpf, nxt, torch.full((B_DC,), S_DC))
        l2, _ = model.decode_step(params, cdec, nxt, torch.full((B_DC,), S_DC))
    assert float((l1 - l2).abs().max()) < PREFILL_DECODE_TOL


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------
class _Capture:
    """An optimizer that keeps the gradients it is handed."""

    def update(self, grads, state, params):
        self.grads = grads
        return params, state


@pytest.mark.parametrize("act", ["bfloat16", "float32"])
def test_train_step_matches_jax(act):
    """One ``make_train_step`` with ``remat: full`` (the shared block runs
    inside each group's checkpoint, so the backward recomputes it) against
    JAX's ``value_and_grad`` of ``compute_loss`` on the same params and
    batch: loss and every leaf's gradient, the shared block's included."""
    jcfg = jax_get_reduced(ARCH)
    assert jcfg.remat == "full"
    jm = jax_build_model(jcfg)
    params = _jax_params(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    toks = np.random.default_rng(1).integers(3, 512, (2, 64)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    pm = build_model(get_reduced(ARCH))
    jembed, pembed = jm.embed_tokens, pm.embed_tokens
    with mock.patch.object(jm, "embed_tokens", lambda p, t: jembed(
            p, t, dtype=getattr(jnp, act))), \
            mock.patch.object(pm, "embed_tokens", lambda p, t: pembed(
                p, t, dtype=getattr(torch, act))):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p, b: JST.compute_loss(jm, p, b)[0]))(jp, jb)
        cap = _Capture()
        state = {"params": params_from_jax(params), "opt": {},
                 "step": torch.zeros((), dtype=torch.int32)}
        _, metrics = PST.make_train_step(pm, cap)(
            state, {k: _t(v) for k, v in batch.items()})
    loss_tol = STEP_LOSS_TOL if act == "bfloat16" else 1e-6
    assert abs(float(metrics["loss"]) - float(jloss)) <= loss_tol * float(jloss)
    grad_tol = STEP_GRAD_TOL if act == "bfloat16" else STEP_F32_TOL
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_leaves_with_path(jgrads)]
    assert any("shared_attn" in p for p in paths)
    for path, a, b in zip(paths, jax.tree_util.tree_leaves(jgrads),
                          tree_leaves(cap.grads)):
        a = _np(a)
        scale = float(np.abs(a).max())
        assert scale > 0, path
        err = float(np.abs(b.float().numpy() - a).max())
        assert err <= grad_tol * scale, (path, err / scale)


def test_remat_policies_give_equal_grads():
    """none, full and selective compute the same ops on the same inputs,
    the shared block's recompute included: equal gradients
    (``torch.equal``)."""
    base = get_reduced(ARCH)
    params = build_model(base).init(torch.Generator().manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        3, 512, (2, 64)), dtype=torch.int64)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    out = {}
    for remat in ("none", "full", "selective"):
        cap = _Capture()
        state = {"params": params, "opt": {},
                 "step": torch.zeros((), dtype=torch.int32)}
        _, metrics = PST.make_train_step(build_model(base.with_(remat=remat)),
                                         cap)(state, batch)
        out[remat] = (metrics["loss"], cap.grads)
    for remat in ("full", "selective"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(tree_leaves(out["none"][1]),
                        tree_leaves(out[remat][1])):
            assert torch.equal(a, b), remat
