"""The port's VLM patch prefix (LLaVA-NeXT-34B's language backbone) against
the JAX package, on the CPU.

Reduced ``llava_next_34b``: 2 dense layers, d_model 256, 4 query heads over
2 KV heads of 64, vocab 512 and 16 stub patch embeddings, with JAX's params
carried across by ``repro_torch.bridge``.  Inputs are numpy draws from a
seed; patch embeddings are ``0.02 * N(0, 1)`` from ``default_rng(1)``.

Tolerances (``tests/test_torch_encdec.py``'s, with the largest value seen
here beside each): ``F32_TOL`` 1e-5 on f32 logits and of the f32 caches'
largest element (1.7e-6 and 1.1e-6 seen); ``BF16_TOL`` 3e-2 on bf16
logits of size ~1 (1.4e-2 seen) and two bf16 steps of the bf16 caches'
largest element (8.7e-3 seen); decode against ``apply`` 5e-4 in f32,
JAX's bound; one train
step 1e-6 / 1e-4 (f32) and 3e-3 / 5e-2 (bf16) of the loss and of each
leaf's largest gradient; greedy streams ``==`` or parting at a top-2 tie
within ``BF16_TOL``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from unittest import mock

import repro.launch.serve as JSERVE
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro.train import steps as JST
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_config, get_reduced
from repro_torch.device import MetaGenerator
from repro_torch.launch.serve import _multimodal_benchmark
from repro_torch.models import build_model
from repro_torch.run import api
from repro_torch.run.cli import main as cli_main
from repro_torch.run.config import RunError
from repro_torch.train import steps as PST
from test_torch_encdec import (BF16_TOL, CONFIGS, DECODE_TOL, DTYPES, F32_TOL,
                               STEP_TOLS, TRAIN_FAMILY, _f32, _jax_stream_logits,
                               _rel, assert_grads_match,
                               assert_streams_match_or_tie, refusal_doc)

ARCH = "llava_next_34b"
B, S = 2, 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Reduced models: their ops are far too small to split across threads,
    and the suite's parallel workers share the host's cores.  One thread
    for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def vl():
    """Reduced LLaVA in both packages on JAX's params, and one batch."""
    jm = jax_build_model(jax_get_reduced(ARCH))
    params = jax.tree_util.tree_map(np.asarray,
                                    jax.jit(jm.init)(jax.random.PRNGKey(0)))
    cfg = get_reduced(ARCH)
    tok = np.random.default_rng(0).integers(0, cfg.vocab,
                                            (B, S)).astype(np.int32)
    patches = (0.02 * np.random.default_rng(1).standard_normal(
        (B, cfg.n_patches, cfg.d_model))).astype(np.float32)
    return {"jm": jm, "params": params,
            "jp": jax.tree_util.tree_map(jnp.asarray, params),
            "model": build_model(cfg), "cfg": cfg,
            "pp": params_from_jax(params), "tok": tok, "patches": patches}


def _acts(vl, dname):
    """Both models with their activations (the embeddings' output) in
    ``dname``, as ``tests/test_torch_train.py`` sets them."""
    pt, jt = DTYPES[dname]
    jm, pm = vl["jm"], vl["model"]
    jembed, pembed = jm.embed_tokens, pm.embed_tokens
    return (mock.patch.object(jm, "embed_tokens",
                              lambda p, t: jembed(p, t, dtype=jt)),
            mock.patch.object(pm, "embed_tokens",
                              lambda p, t: pembed(p, t, dtype=pt)))


def _batches(vl, patches=True, labels=False):
    jb = {"tokens": jnp.asarray(vl["tok"])}
    pb = {"tokens": torch.tensor(vl["tok"])}
    if patches:
        jb["patch_embeds"] = jnp.asarray(vl["patches"])
        pb["patch_embeds"] = torch.tensor(vl["patches"])
    if labels:
        lab = np.roll(vl["tok"], -1, axis=1)
        jb["labels"], pb["labels"] = jnp.asarray(lab), torch.tensor(lab)
    return jb, pb


def _tol(dname):
    return F32_TOL if dname == "float32" else BF16_TOL


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
def test_param_tree_and_axes_match_jax(full):
    """The tree and shapes on ``meta`` are JAX's ``eval_shape`` (60 layers,
    34.4 B params at full width), the axes JAX's ``param_axes``."""
    cfg = get_config(ARCH) if full else get_reduced(ARCH)
    jcfg = jax_get_config(ARCH) if full else jax_get_reduced(ARCH)
    model, jm = build_model(cfg), jax_build_model(jcfg)
    mine = model.init(MetaGenerator())
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    shapes = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: tuple(a.shape), t)
    assert shapes(mine) == shapes(want)
    assert model.param_axes() == jax.tree_util.tree_map(
        tuple, jm.param_axes(), is_leaf=lambda t: isinstance(t, tuple))
    n = sum(a.numel() for a in jax.tree_util.tree_leaves(mine))
    assert n == sum(int(np.prod(a.shape))
                    for a in jax.tree_util.tree_leaves(want))
    if full:
        assert n == 34_388_917_248


# ---------------------------------------------------------------------------
# the patch prefix against JAX's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("patches", [True, False],
                         ids=["patches", "tokens_only"])
@pytest.mark.parametrize("dname", DTYPES)
def test_apply_matches_jax(vl, dname, patches):
    """With patch embeddings in the batch the logits cover ``n_patches +
    S`` rows; without, the text alone, as JAX's ``apply``."""
    jb, pb = _batches(vl, patches)
    a, b = _acts(vl, dname)
    with a, b:
        want, _ = jax.jit(vl["jm"].apply)(vl["jp"], jb)
        with torch.no_grad():
            got, _ = vl["model"].apply(vl["pp"], pb)
    rows = S + (vl["cfg"].n_patches if patches else 0)
    assert tuple(got.shape) == (B, rows, vl["cfg"].vocab)
    assert float(np.abs(got.float().numpy() - _f32(want)).max()) <= _tol(dname)


@pytest.mark.parametrize("dname", DTYPES)
def test_prefill_matches_jax(vl, dname):
    """Logits and the whole cache tree: ``n_patches + S`` rows written."""
    pt, jt = DTYPES[dname]
    jb, pb = _batches(vl)
    n = vl["cfg"].n_patches
    a, b = _acts(vl, dname)
    with a, b:
        jl, jc = jax.jit(lambda p, b: vl["jm"].prefill(
            p, b, max_len=n + S + 4, cache_dtype=jt))(vl["jp"], jb)
        pl, pc = vl["model"].prefill(vl["pp"], pb, max_len=n + S + 4,
                                     cache_dtype=pt)
    assert float(np.abs(pl.float().numpy() - _f32(jl)).max()) <= _tol(dname)
    got, want = params_to_numpy(pc), jax.tree_util.tree_map(_f32, jc)
    assert got["blocks"]["k"].shape == (2, B, n + S + 4, 2, 64)
    cache_tol = F32_TOL if dname == "float32" else 2 * 2.0 ** -7
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape and _rel(g, w) <= cache_tol
        assert not g[:, :, n + S:].any()


def test_decode_after_patch_prefill_matches_apply_f32(vl):
    """The shim's lengths: a prefill of patches and prompt into ``n_patches
    + P + G`` rows, then decode at positions ``n_patches + P + i``,
    reproduce ``apply`` on the same patches and tokens (f32)."""
    jb, pb = _batches(vl)
    n, P = vl["cfg"].n_patches, S // 2
    model, pp = vl["model"], vl["pp"]
    _, b = _acts(vl, "float32")
    with b, torch.no_grad():
        full, _ = model.apply(pp, pb)
        lg, cache = model.prefill(pp, {"tokens": pb["tokens"][:, :P],
                                       "patch_embeds": pb["patch_embeds"]},
                                  max_len=n + S, cache_dtype=torch.float32)
        outs = [lg]
        for i in range(P, S):
            lg, cache = model.decode_step(pp, cache, pb["tokens"][:, i],
                                          torch.full((B,), n + i))
            outs.append(lg)
    got = torch.stack(outs, 1)
    assert float((got - full[:, n + P - 1:]).abs().max()) < DECODE_TOL


@pytest.mark.parametrize("dname", DTYPES)
def test_compute_loss_and_train_step_match_jax(vl, dname):
    """JAX's ``compute_loss`` (the first ``n_patches`` logits dropped) under
    ``jax.value_and_grad`` against the port's ``make_train_step`` on a batch
    that carries patch embeddings, as ``tests/test_arch_smoke.py`` drives
    JAX's."""
    jb, pb = _batches(vl, labels=True)
    a, b = _acts(vl, dname)

    class Capture:
        def update(self, grads, state, params):
            self.grads = grads
            return params, state

    cap = Capture()
    with a, b:
        (jl, jmet), jg = jax.jit(jax.value_and_grad(
            lambda p: JST.compute_loss(vl["jm"], p, jb),
            has_aux=True))(vl["jp"])
        pl, pmet = PST.compute_loss(vl["model"], vl["pp"], pb)
        state = {"params": vl["pp"], "opt": {},
                 "step": torch.zeros((), dtype=torch.int32)}
        _, metrics = PST.make_train_step(vl["model"], cap)(state, pb)
    loss_tol, grad_tol = STEP_TOLS[dname]
    assert set(pmet) == set(jmet) == {"ce", "router_lb"}
    for got in (float(pl), float(metrics["loss"])):
        assert abs(got - float(jl)) <= loss_tol * float(jl)
    assert_grads_match(params_to_numpy(cap.grads),
                       jax.tree_util.tree_map(_f32, jg), grad_tol)


# ---------------------------------------------------------------------------
# the serving shim
# ---------------------------------------------------------------------------
def test_vlm_shim_keeps_the_prompt_where_jax_drops_it(vl):
    """JAX's shim keeps ``P + G`` cache rows: the first ``P + G`` of the
    ``n_patches + P`` the prefill wrote, the patches', and decodes over
    them at positions ``P + i``.  The port's keeps ``n_patches + P + G``
    rows and decodes at ``n_patches + P + i``: its streams are greedy over
    JAX's ``apply`` on the patches, the prompt and the tokens so far, and
    JAX's own ``prefill`` and ``make_serve_step`` at those lengths; JAX's
    shim's are not."""
    cfg = vl["cfg"]
    P, G, n = 8, 4, cfg.n_patches
    prompts = np.random.default_rng(5).integers(3, cfg.vocab, (B, P),
                                                dtype=np.int32)
    got = _multimodal_benchmark(vl["model"], vl["pp"], prompts, G,
                                torch.device("cpu"),
                                lambda m: None)["generated_ids"]
    patches = jnp.zeros((B, n, cfg.d_model))
    toks, logits = _jax_stream_logits(vl["jm"], vl["jp"], prompts, G,
                                      n_pre=n, patches=patches)
    assert_streams_match_or_tie(got, toks, logits)
    seq, greedy, g_logits = jnp.asarray(prompts), [], []
    japply = jax.jit(vl["jm"].apply)
    for _ in range(G):
        lg, _ = japply(vl["jp"], {"tokens": seq, "patch_embeds": patches})
        g_logits.append(_f32(lg[:, -1]))
        greedy.append(np.argmax(g_logits[-1], -1).astype(np.int32))
        seq = jnp.concatenate([seq, jnp.asarray(greedy[-1])[:, None]], 1)
    assert_streams_match_or_tie(got, np.stack(greedy, 1),
                                np.stack(g_logits, 1))
    jax_shim = JSERVE._multimodal_benchmark(vl["jm"], vl["jp"],
                                            jnp.asarray(prompts), G,
                                            lambda m: None)["generated_ids"]
    assert np.asarray(jax_shim).shape == np.asarray(got).shape
    assert np.asarray(jax_shim).tolist() != np.asarray(got).tolist()


# ---------------------------------------------------------------------------
# the run API
# ---------------------------------------------------------------------------
def test_cli_serves_llava_on_the_cpu(tmp_path, capsys):
    rc = cli_main(["serve", "--config", os.path.join(CONFIGS, "serve.yaml"),
                   "--device", "cpu", "--set", f"arch.variant_key={ARCH}",
                   "--set", f"run.output_dir={tmp_path / 'out'}"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "prefill: 4x32 tokens in" in out and "decode:  4x15 tokens" in out


@pytest.mark.parametrize("yaml_name,kind", TRAIN_FAMILY,
                         ids=[k for _, k in TRAIN_FAMILY])
def test_train_family_kinds_refuse_llava(tmp_path, yaml_name, kind):
    """Each train-family kind refuses before its first step with a
    ``RunError`` naming the missing patch embeddings (JAX's gym fails in
    an einsum over the labels instead)."""
    with pytest.raises(RunError, match=rf"^{kind}: .*'patch_embeds'"):
        api.execute_doc(refusal_doc(tmp_path, yaml_name, ARCH), device="cpu",
                        log=lambda m: None)
