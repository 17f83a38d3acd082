"""The port's encoder-decoder (Whisper-tiny's backbone) against the JAX
package, on the CPU.

Reduced ``whisper_tiny``: 2 encoder and 2 decoder layers, d_model 256, 4
heads of 64, 64 encoder frames, vocab 512, layernorm with bias, tanh-GELU,
QKV bias, with JAX's params carried across by ``repro_torch.bridge``.
Inputs are numpy draws from a seed; frames are ``0.02 * N(0, 1)``, as
``tests/test_arch_smoke.py`` makes them.

Tolerances, stated per assertion (the largest value seen here beside each):

- the attention functions in f32: ``FN_TOL`` 2e-5 of the output's largest
  element (the same f32 products summed in other orders; 4e-7 seen);
- the model in f32 (``apply``, ``prefill``'s logits, 2 decode steps):
  ``F32_TOL`` 1e-5 (8e-7 seen); the caches in f32 the same bound of their
  largest element (8e-7 seen);
- the model in bf16: ``BF16_TOL`` 3e-2 on logits of size ~1 (the two
  packages round at other places; 7.8e-3 seen, one bf16 step at 1), and
  the bf16 caches within two bf16 steps (2 * 2**-7) of their largest
  element (7.5e-3 seen, one step);
- decode against ``apply`` in f32: 5e-4, JAX's own bound
  (``tests/test_decode_consistency.py``);
- one train step: 1e-6 of the loss and 1e-4 of each leaf's largest
  gradient in f32, 3e-3 and 5e-2 in bf16 (``tests/test_torch_moe.py``'s
  bounds), the key biases' against the tree's largest gradient
  (``assert_grads_match``);
- the serving shim's greedy streams: ``==`` JAX's, or they part where
  JAX's top-2 logits lie within ``BF16_TOL`` and the port took JAX's
  second (an argmax tie in bf16).
"""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as JSERVE
import repro.models.attention as JA
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro.models.encdec import EncDecLM as JaxEncDecLM
from repro.train import steps as JST
import repro_torch.models.attention as PA
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_config, get_reduced
from repro_torch.device import MetaGenerator
from repro_torch.launch.serve import _multimodal_benchmark
from repro_torch.models import build_model
from repro_torch.models.encdec import EncDecLM
from repro_torch.run import api
from repro_torch.run.cli import main as cli_main
from repro_torch.run.config import RunError
from repro_torch.config.resolver import load_yaml
from repro_torch.run.overrides import apply_overrides, parse_overrides
from repro_torch.train import steps as PST

ARCH = "whisper_tiny"
ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = os.path.join(ROOT, "examples", "configs")
FN_TOL = 2e-5
F32_TOL = 1e-5
BF16_TOL = 3e-2
DECODE_TOL = 5e-4
STEP_TOLS = {"float32": (1e-6, 1e-4), "bfloat16": (3e-3, 5e-2)}
B, S = 2, 12
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Reduced models: their ops are far too small to split across threads,
    and the suite's parallel workers share the host's cores.  One thread
    for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def acts(monkeypatch):
    """``acts(name)`` sets both packages' activation dtype for this test
    (JAX's tests set the class attribute, as here)."""
    def set_(name):
        pt, jt = DTYPES[name]
        monkeypatch.setattr(JaxEncDecLM, "act_dtype", jt)
        monkeypatch.setattr(EncDecLM, "act_dtype", pt)
        return pt, jt

    return set_


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


@pytest.fixture(scope="module")
def wh():
    """Reduced Whisper in both packages on JAX's params, and one batch."""
    jcfg = jax_get_reduced(ARCH)
    jm = jax_build_model(jcfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    jax.jit(jm.init)(jax.random.PRNGKey(0)))
    cfg = get_reduced(ARCH)
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    frames = (0.02 * rng.standard_normal(
        (B, cfg.encoder_frames, cfg.d_model))).astype(np.float32)
    return {"jm": jm, "params": params,
            "jp": jax.tree_util.tree_map(jnp.asarray, params),
            "model": build_model(cfg), "cfg": cfg,
            "pp": params_from_jax(params), "tok": tok, "frames": frames}


def _batches(wh, labels=False):
    jb = {"tokens": jnp.asarray(wh["tok"]), "frames": jnp.asarray(wh["frames"])}
    pb = {"tokens": torch.tensor(wh["tok"]),
          "frames": torch.tensor(wh["frames"])}
    if labels:
        lab = np.roll(wh["tok"], -1, axis=1)
        jb["labels"], pb["labels"] = jnp.asarray(lab), torch.tensor(lab)
    return jb, pb


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------
def test_build_model_gives_the_encoder_decoder():
    assert isinstance(build_model(get_config(ARCH)), EncDecLM)


@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
def test_param_tree_and_axes_match_jax(full):
    """The tree and shapes on ``meta`` are JAX's ``eval_shape``, the axes
    JAX's ``param_axes``."""
    cfg = get_config(ARCH) if full else get_reduced(ARCH)
    jcfg = jax_get_config(ARCH) if full else jax_get_reduced(ARCH)
    model, jm = build_model(cfg), jax_build_model(jcfg)
    mine = model.init(MetaGenerator())
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    shapes = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: tuple(a.shape), t)
    assert shapes(mine) == shapes(want)
    assert list(mine) == ["embed", "pos_embed", "enc_pos_embed", "enc_blocks",
                          "enc_norm", "dec_blocks", "final_norm"]
    assert model.param_axes() == jax.tree_util.tree_map(
        tuple, jm.param_axes(), is_leaf=lambda t: isinstance(t, tuple))
    if full:
        n = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(want))
        assert n == sum(a.numel() for a in jax.tree_util.tree_leaves(mine))


def test_cache_has_jax_shapes(wh):
    jm, model = wh["jm"], wh["model"]
    mine = model.init_cache(B, 16, dtype=torch.float32)
    want = jm.init_cache(B, 16, dtype=jnp.float32)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), mine) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), want)


# ---------------------------------------------------------------------------
# the attention functions, f32
# ---------------------------------------------------------------------------
def _layer(wh, name):
    p = jax.tree_util.tree_map(lambda a: a[0],
                               wh["params"]["dec_blocks"][name])
    return jax.tree_util.tree_map(jnp.asarray, p), params_from_jax(p)


@pytest.mark.parametrize("fn", ["bidir_forward", "cross_kv", "cross_forward"])
def test_attention_function_matches_jax(wh, fn):
    cfg, jcfg = wh["cfg"], wh["jm"].cfg
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, cfg.encoder_frames,
                               cfg.d_model)).astype(np.float32)
    jp, pp = _layer(wh, "cross_attn")
    if fn == "bidir_forward":
        want = [JA.bidir_forward(jcfg, jp, jnp.asarray(x))]
        got = [PA.bidir_forward(cfg, pp, torch.tensor(x))]
    elif fn == "cross_kv":
        want = JA.cross_kv(jcfg, jp, jnp.asarray(enc))
        got = PA.cross_kv(cfg, pp, torch.tensor(enc))
    else:
        want = [JA.cross_forward(jcfg, jp, jnp.asarray(x),
                                 JA.cross_kv(jcfg, jp, jnp.asarray(enc)))]
        got = [PA.cross_forward(cfg, pp, torch.tensor(x),
                                PA.cross_kv(cfg, pp, torch.tensor(enc)))]
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert _rel(g.numpy(), _f32(w)) <= FN_TOL


# ---------------------------------------------------------------------------
# the model against JAX's
# ---------------------------------------------------------------------------
def _tol(dname):
    return F32_TOL if dname == "float32" else BF16_TOL


@pytest.mark.parametrize("dname", DTYPES)
def test_apply_matches_jax(wh, acts, dname):
    acts(dname)
    jb, pb = _batches(wh)
    want, _ = jax.jit(wh["jm"].apply)(wh["jp"], jb)
    got, aux = wh["model"].apply(wh["pp"], pb)
    assert aux == {} and got.dtype == DTYPES[dname][0]
    assert tuple(got.shape) == (B, S, wh["cfg"].vocab)
    assert float(np.abs(got.float().numpy() - _f32(want)).max()) <= _tol(dname)


@pytest.mark.parametrize("dname", DTYPES)
def test_prefill_and_two_decode_steps_match_jax(wh, acts, dname):
    """Logits and the whole cache tree after ``prefill``, then the logits
    of two decode steps on the same tokens."""
    pt, jt = acts(dname)
    jb, pb = _batches(wh)
    jl, jc = jax.jit(lambda p, b: wh["jm"].prefill(
        p, b, max_len=S + 4, cache_dtype=jt))(wh["jp"], jb)
    pl, pc = wh["model"].prefill(wh["pp"], pb, max_len=S + 4, cache_dtype=pt)
    tol = _tol(dname)
    assert float(np.abs(pl.float().numpy() - _f32(jl)).max()) <= tol
    cache_tol = F32_TOL if dname == "float32" else 2 * 2.0 ** -7
    got_c = params_to_numpy(pc)
    want_c = jax.tree_util.tree_map(_f32, jc)
    assert jax.tree_util.tree_map(lambda a: a.shape, got_c) == \
        jax.tree_util.tree_map(lambda a: a.shape, want_c)
    for g, w in zip(jax.tree_util.tree_leaves(got_c),
                    jax.tree_util.tree_leaves(want_c)):
        assert g.dtype == np.float32 and _rel(g, w) <= cache_tol
    assert pc["cross_k"].dtype == pt
    tokens = np.argmax(_f32(jl), -1).astype(np.int32)
    jdecode = jax.jit(wh["jm"].decode_step)
    for i in range(2):
        pos = np.full((B,), S + i, np.int32)
        jl, jc = jdecode(wh["jp"], jc, jnp.asarray(tokens), jnp.asarray(pos))
        pl, pc = wh["model"].decode_step(wh["pp"], pc, torch.tensor(tokens),
                                         torch.tensor(pos))
        assert float(np.abs(pl.float().numpy() - _f32(jl)).max()) <= tol
        tokens = np.argmax(_f32(jl), -1).astype(np.int32)


def test_decode_matches_apply_f32(wh, acts):
    """JAX's decode-consistency contract in the port: ``init_cache``,
    ``prefill_cross`` and a decode step a token reproduce ``apply``; and so
    does the shim's path, ``prefill`` then decode."""
    acts("float32")
    jb, pb = _batches(wh)
    model, pp = wh["model"], wh["pp"]
    full, _ = model.apply(pp, pb)
    cache = model.init_cache(B, S, dtype=torch.float32)
    cache = model.prefill_cross(pp, cache, pb["frames"])
    outs = []
    for pos in range(S):
        lg, cache = model.decode_step(pp, cache, pb["tokens"][:, pos],
                                      torch.full((B,), pos))
        outs.append(lg)
    assert float((torch.stack(outs, 1) - full).abs().max()) < DECODE_TOL
    P = S // 2
    lg, cache = model.prefill(pp, {"tokens": pb["tokens"][:, :P],
                                   "frames": pb["frames"]},
                              max_len=S, cache_dtype=torch.float32)
    outs = [lg]
    for pos in range(P, S):
        lg, cache = model.decode_step(pp, cache, pb["tokens"][:, pos],
                                      torch.full((B,), pos))
        outs.append(lg)
    assert float((torch.stack(outs, 1) - full[:, P - 1:]).abs().max()) \
        < DECODE_TOL


@pytest.mark.parametrize("dname", DTYPES)
def test_compute_loss_and_train_step_match_jax(wh, acts, dname):
    """JAX's ``compute_loss`` under ``jax.value_and_grad`` against the port's
    ``make_train_step`` (its gradients caught by the optimizer) on the
    same params and a batch that carries frames, as
    ``tests/test_arch_smoke.py`` drives JAX's."""
    acts(dname)
    jb, pb = _batches(wh, labels=True)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: JST.compute_loss(wh["jm"], p, jb), has_aux=True))(wh["jp"])
    pl, pmet = PST.compute_loss(wh["model"], wh["pp"], pb)
    loss_tol, grad_tol = STEP_TOLS[dname]
    assert abs(float(pl) - float(jl)) <= loss_tol * float(jl)
    assert set(pmet) == set(jmet) == {"ce"}

    class Capture:
        def update(self, grads, state, params):
            self.grads = grads
            return params, state

    cap = Capture()
    state = {"params": wh["pp"], "opt": {}, "step": torch.zeros((), dtype=torch.int32)}
    _, metrics = PST.make_train_step(wh["model"], cap)(state, pb)
    assert abs(float(metrics["loss"]) - float(jl)) <= loss_tol * float(jl)
    assert_grads_match(params_to_numpy(cap.grads),
                       jax.tree_util.tree_map(_f32, jg), grad_tol)


def assert_grads_match(got, want, tol):
    """Each leaf's gradient within ``tol`` of its largest element.  A key
    bias (``bk``) takes gradient 0 in exact arithmetic: ``q . bk`` is the
    same for every key of a query, and the softmax drops it, so both
    packages return rounding noise there; it is held within ``tol`` of the
    tree's largest gradient instead."""
    top = max(float(np.abs(w).max())
              for w in jax.tree_util.tree_leaves(want))
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        key = jax.tree_util.keystr(path)
        assert np.isfinite(g).all(), key
        scale = top if key.endswith("['bk']") else float(np.abs(w).max())
        assert scale > 0, key
        assert float(np.abs(g - w).max()) <= tol * scale, key


# ---------------------------------------------------------------------------
# the serving shim
# ---------------------------------------------------------------------------
def _jax_stream_logits(jm, jp, prompts, G, n_pre=0, frames=None,
                       patches=None):
    """JAX's ``prefill`` and ``make_serve_step`` at ``n_pre + P + G`` rows
    and positions ``n_pre + P + i`` (JAX's shim at ``n_pre`` 0): the
    greedy stream ``[B, G]`` and the logits that chose each token."""
    Bq, P = prompts.shape
    batch = {"tokens": jnp.asarray(prompts)}
    if frames is not None:
        batch["frames"] = frames
    if patches is not None:
        batch["patch_embeds"] = patches
    logits, cache = jax.jit(lambda p, b: jm.prefill(
        p, b, max_len=n_pre + P + G))(jp, batch)
    step = jax.jit(JST.make_serve_step(jm))
    toks, outs = [jnp.argmax(logits, -1).astype(jnp.int32)], [logits]
    for i in range(G - 1):
        tok, logits, cache = step(jp, cache, toks[-1],
                                  jnp.full((Bq,), n_pre + P + i, jnp.int32))
        toks.append(tok)
        outs.append(logits)
    return (np.stack([np.asarray(t) for t in toks], 1),
            np.stack([_f32(o) for o in outs], 1))


def assert_streams_match_or_tie(got, want, logits, tol=BF16_TOL):
    """Each row ``==``, or parting first where JAX's top-2 logits lie
    within ``tol`` and the port took JAX's second."""
    for r, (g, w) in enumerate(zip(np.asarray(got), np.asarray(want))):
        diff = np.nonzero(g != w)[0]
        if not diff.size:
            continue
        i = int(diff[0])
        order = np.argsort(logits[r, i])
        top2 = logits[r, i, order[-2:]]
        assert top2[1] - top2[0] <= tol, (r, i)
        assert g[i] == order[-2], (r, i)


def test_shim_streams_match_jax_or_tie(wh):
    """The port's ``_multimodal_benchmark`` against JAX's on the same numpy
    prompts, zero frames, bf16 activations, the same keys."""
    cfg = wh["cfg"]
    P, G = 8, 4
    prompts = np.random.default_rng(5).integers(3, cfg.vocab, (B, P),
                                                dtype=np.int32)
    want = JSERVE._multimodal_benchmark(wh["jm"], wh["jp"],
                                        jnp.asarray(prompts), G,
                                        lambda m: None)
    got = _multimodal_benchmark(wh["model"], wh["pp"], prompts, G,
                                torch.device("cpu"), lambda m: None)
    assert set(got) == set(want) and "tpot_ms" not in got
    for key in ("batch", "prompt_len", "gen", "decode_steps", "decode_tokens",
                "gen_tokens_total"):
        assert got[key] == want[key], key
    frames = jnp.zeros((B, cfg.encoder_frames, cfg.d_model))
    toks, logits = _jax_stream_logits(wh["jm"], wh["jp"], prompts, G,
                                      frames=frames)
    np.testing.assert_array_equal(toks, want["generated_ids"])
    assert_streams_match_or_tie(got["generated_ids"], want["generated_ids"],
                                logits)


def test_full_width_prefill_matches_jax_f32(acts):
    """Whisper-tiny at every width and depth of its config (1500 frames,
    vocab 51865), one 16-token prompt, f32."""
    acts("float32")
    t0 = time.perf_counter()
    jm = jax_build_model(jax_get_config(ARCH))
    params = jax.tree_util.tree_map(np.asarray,
                                    jax.jit(jm.init)(jax.random.PRNGKey(0)))
    model = build_model(get_config(ARCH))
    cfg = model.cfg
    rng = np.random.default_rng(7)
    tok = rng.integers(3, cfg.vocab, (1, 16)).astype(np.int32)
    frames = (0.02 * rng.standard_normal(
        (1, cfg.encoder_frames, cfg.d_model))).astype(np.float32)
    want, _ = jax.jit(lambda p, b: jm.prefill(p, b, cache_dtype=jnp.float32))(
        jax.tree_util.tree_map(jnp.asarray, params),
        {"tokens": jnp.asarray(tok), "frames": jnp.asarray(frames)})
    got, _ = model.prefill(params_from_jax(params),
                           {"tokens": torch.tensor(tok),
                            "frames": torch.tensor(frames)},
                           cache_dtype=torch.float32)
    assert float(np.abs(got.numpy() - _f32(want)).max()) <= F32_TOL
    assert time.perf_counter() - t0 < 30


# ---------------------------------------------------------------------------
# the run API
# ---------------------------------------------------------------------------
def test_cli_serves_whisper_on_the_cpu(tmp_path, capsys):
    rc = cli_main(["serve", "--config", os.path.join(CONFIGS, "serve.yaml"),
                   "--device", "cpu", "--set", f"arch.variant_key={ARCH}",
                   "--set", f"run.output_dir={tmp_path / 'out'}"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "prefill: 4x32 tokens in" in out and "decode:  4x15 tokens" in out


TRAIN_FAMILY = [("quickstart", "train"), ("warmstart", "warmstart"),
                ("bench", "bench"), ("sft", "sft"), ("dpo", "dpo")]


def refusal_doc(tmp_path, yaml_name, arch):
    doc = load_yaml(os.path.join(CONFIGS, f"{yaml_name}.yaml"))
    sets = [f"arch.variant_key={arch}", f"run.output_dir={tmp_path / 'out'}"]
    if "prefix" in doc["dataset"]["config"]:
        sets.append(f"dataset.config.prefix={tmp_path / 'data'}")
    return apply_overrides(doc, parse_overrides(sets))


@pytest.mark.parametrize("yaml_name,kind", TRAIN_FAMILY,
                         ids=[k for _, k in TRAIN_FAMILY])
def test_train_family_kinds_refuse_whisper(tmp_path, yaml_name, kind):
    """The loader yields tokens only: each train-family kind refuses before
    its first step, with a ``RunError`` that names the missing frames
    (JAX's gym raises ``KeyError: 'frames'``)."""
    with pytest.raises(RunError, match=rf"^{kind}: .*'frames'"):
        api.execute_doc(refusal_doc(tmp_path, yaml_name, ARCH), device="cpu",
                        log=lambda m: None)
