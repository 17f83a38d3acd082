"""The port's post-training (``repro_torch.posttrain``: LoRA and SFT, and
the ``sft`` kind) against the JAX package's, on the CPU, on reduced
Qwen1.5-0.5B (reduced Zamba2 and Mamba2 where named).  Inputs are numpy
arrays from a seed; JAX's params (with non-zero ``b`` factors, so the
adapters matter) are carried across by ``repro_torch.bridge``.

The port's own invariants hold bitwise (``==``), as JAX's own tests hold
JAX (``tests/test_posttrain.py``): a fresh adapter is a no-op, the merged
forward is the on-the-fly forward, an adapter checkpoint round-trips, the
frozen base never moves.  Against JAX:

- layouts and counts (``param_axes``, ``adapter_shapes``, ``n_trainable``,
  the datasets' rows, the adapter checkpoint's files) are ``==``;
- ``merge_tree``: ``MERGE_TOL`` 1e-6, absolute, on weights of size up to
  ~0.5.  Both packages compute ``W + s * (a @ b)`` in f32 with one rounding
  of the rank-4 product and one of the sum; the product's terms are summed
  in other orders, which moves it by a few f32 steps of its size (~1e-3),
  about 1e-10, and the sum can round the other way, one f32 step of ``W``
  (6e-8 at 0.5);
- LoRA forward logits: ``LOGIT_TOL`` 3e-2, the bound of the dense parity
  tests (``tests/test_torch_serve.py``: bf16 activations rounded at other
  places), and with f32 activations ``F32_LOGIT_TOL`` 1e-4
  (``tests/test_torch_train.py``);
- ``FrozenBaseOptimizer.update``: ``ADAM_TOL`` 1e-5 (``tests/test_torch_train.py``);
- the ``sft`` kind, warmstarted with ``carry`` from one JAX checkpoint in
  both packages: ``CURVE_TOL`` 2e-3 on the losses (``tests/test_torch_gym.py``:
  bf16 rounding over a few steps).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from unittest import mock

import repro.core.components  # noqa: F401  (JAX's catalog)
import repro.run.kinds  # noqa: F401  (JAX's run kinds)
from repro.ckpt import elastic as JEL
from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro.optim.adamw import AdamW as JaxAdamW
from repro.posttrain import lora as JLO
from repro.posttrain import sft as JSFT
from repro.run import api as jax_api
from repro.run.config import RunError as JaxRunError
from repro.run.config import parse_run_doc as jax_parse_run_doc
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.ckpt import elastic as EL
from repro_torch.ckpt.format import (flatten_with_paths, latest_checkpoint,
                                     read_leaf, read_manifest)
from repro_torch.configs import get_reduced
from repro_torch.device import MetaGenerator
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.posttrain import lora as LO
from repro_torch.posttrain import sft as SFT
from repro_torch.run import api
from repro_torch.run.cli import main as cli_main
from repro_torch.run.config import RunError, parse_run_doc
from repro_torch.train import steps as PST
from repro_torch.tree import tree_leaves, tree_map

ROOT = os.path.join(os.path.dirname(__file__), "..")
SFT_YAML = os.path.join(ROOT, "examples", "configs", "sft.yaml")
MERGE_TOL = 1e-6
LOGIT_TOL = 3e-2        # tests/test_torch_serve.py
F32_LOGIT_TOL = 1e-4    # tests/test_torch_train.py
ADAM_TOL = 1e-5         # tests/test_torch_train.py
CURVE_TOL = 2e-3        # tests/test_torch_gym.py
QWEN = "qwen1p5_0p5b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Reduced models: their ops are far too small to split across threads,
    and under the suite's parallel workers one thread per core leaves each
    op waiting on descheduled threads.  One thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(_msg):
    pass


def _perturbed(jlm, seed=1):
    """JAX's LoRA init with non-zero ``b`` factors (seeded numpy noise), as
    numpy."""
    params = jax.tree_util.tree_map(np.asarray,
                                    jax.jit(jlm.init)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    params[JLO.ADAPTER_KEY] = jax.tree_util.tree_map(
        lambda x: x + (0.02 * rng.standard_normal(x.shape)).astype(x.dtype),
        params[JLO.ADAPTER_KEY])
    return params


@pytest.fixture(scope="module")
def qwen():
    """Reduced Qwen, LoRA rank 4, in both packages, with JAX's perturbed
    params (numpy) and the port's copy of them."""
    jlm = JLO.LoRAModel(jax_build_model(jax_get_reduced(QWEN)),
                        JLO.LoRAConfig(rank=4))
    lm = LO.LoRAModel(build_model(get_reduced(QWEN)), LO.LoRAConfig(rank=4))
    jp = _perturbed(jlm)
    return {"jlm": jlm, "lm": lm, "jp": jp, "params": params_from_jax(jp)}


def _tokens(vocab, b=2, s=12, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def _apply(lm, params, toks):
    with torch.no_grad():
        logits, _ = lm.apply(params, {"tokens": torch.as_tensor(toks)})
    return logits


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def _get(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return tree


# ---------------------------------------------------------------------------
# layouts and counts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", [QWEN, "mamba2_780m", "zamba2_2p7b"])
def test_param_axes_equal_jax(arch):
    assert build_model(get_reduced(arch)).param_axes() == \
        jax_build_model(jax_get_reduced(arch)).param_axes()


@pytest.mark.parametrize("arch", [QWEN, "zamba2_2p7b"])
def test_adapter_shapes_axes_and_counts_equal_jax(arch):
    """Zamba2's default targets hit only its unstacked ``shared_attn``
    block: its factors have no layer dim."""
    lm = LO.LoRAModel(build_model(get_reduced(arch)), LO.LoRAConfig(rank=4))
    jlm = JLO.LoRAModel(jax_build_model(jax_get_reduced(arch)),
                        JLO.LoRAConfig(rank=4))
    assert _shapes(lm.adapter_shapes()) == _shapes(jlm.adapter_shapes())
    assert lm.param_axes() == jlm.param_axes()
    shapes = lm.init(MetaGenerator())
    assert _shapes(shapes) == _shapes(
        jax.eval_shape(jlm.init, jax.random.PRNGKey(0)))
    assert LO.n_trainable(shapes) == JLO.n_trainable(
        jax.eval_shape(jlm.init, jax.random.PRNGKey(0)))
    if arch == "zamba2_2p7b":
        assert list(lm.adapter_shapes()) == ["shared_attn"]
        assert _shapes(lm.adapter_shapes())["shared_attn"]["attn"]["wo"] == \
            {"a": (lm.cfg.n_heads, 4),
             "b": (4, lm.cfg.head_dim_, lm.cfg.d_model)}


def test_n_trainable_of_full_width_qwen_equals_jax():
    """Full-width Qwen1.5-0.5B at rank 8 with the default targets, counted
    on ``meta`` against JAX's ``eval_shape``: ``wo [L, H, dh, D]`` gets
    ``a [L, H, r]`` and ``b [L, r, dh, D]`` (524,416 of the 665,728 a
    layer)."""
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config

    lm = LO.LoRAModel(build_model(get_config(QWEN)), LO.LoRAConfig(rank=8))
    jlm = JLO.LoRAModel(jax_build_model(jax_get_config(QWEN)),
                        JLO.LoRAConfig(rank=8))
    got = LO.n_trainable(lm.init(MetaGenerator()))
    assert got == JLO.n_trainable(jax.eval_shape(jlm.init,
                                                 jax.random.PRNGKey(0)))
    assert got == (15977472, 479965184)
    wo = lm.adapter_shapes()["blocks"]["attn"]["wo"]
    assert sum(np.prod(t.shape) for t in wo.values()) // 24 == 524416


def test_mamba2_default_targets_match_no_matrix_as_in_jax():
    with pytest.raises(ValueError) as ours:
        LO.LoRAModel(build_model(get_reduced("mamba2_780m")), LO.LoRAConfig())
    with pytest.raises(ValueError) as theirs:
        JLO.LoRAModel(jax_build_model(jax_get_reduced("mamba2_780m")),
                      JLO.LoRAConfig())
    assert str(ours.value) == str(theirs.value)
    assert "match no matrix leaves" in str(ours.value)


# ---------------------------------------------------------------------------
# the merge and the forward against JAX
# ---------------------------------------------------------------------------
def test_merge_tree_matches_jax_highest(qwen):
    want = jax.tree_util.tree_map(np.asarray, qwen["jlm"].merge(qwen["jp"]))
    got = params_to_numpy(qwen["lm"].merge(qwen["params"]))
    assert _shapes(got) == _shapes(want)
    moved = 0
    for (path, a), (_, b) in zip(flatten_with_paths(want),
                                 flatten_with_paths(got)):
        np.testing.assert_allclose(b, a, atol=MERGE_TOL, rtol=0, err_msg=path)
        moved += not np.array_equal(a, _get(qwen["jp"], path))
    assert moved == 7          # the seven default targets


@pytest.mark.parametrize("act", ["bfloat16", "float32"])
def test_lora_forward_logits_match_jax(qwen, act):
    toks = _tokens(qwen["lm"].cfg.vocab)
    jbase, pbase = qwen["jlm"].base, qwen["lm"].base
    jembed, pembed = jbase.embed_tokens, pbase.embed_tokens
    with mock.patch.object(jbase, "embed_tokens", lambda p, t: jembed(
            p, t, dtype=getattr(jnp, act))), \
            mock.patch.object(pbase, "embed_tokens", lambda p, t: pembed(
                p, t, dtype=getattr(torch, act))):
        want, _ = qwen["jlm"].apply(qwen["jp"], {"tokens": jnp.asarray(toks)})
        got = _apply(qwen["lm"], qwen["params"], toks)
    tol = LOGIT_TOL if act == "bfloat16" else F32_LOGIT_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# the port's bitwise invariants (tests/test_posttrain.py)
# ---------------------------------------------------------------------------
def test_lora_injection_is_exact_noop():
    """b = 0 at init: the wrapped forward is bitwise the base forward, and
    the base params are those ``base.init`` makes from the same seed."""
    base = build_model(get_reduced(QWEN))
    lm = LO.LoRAModel(base, LO.LoRAConfig(rank=4))
    params = lm.init(torch.Generator().manual_seed(0))
    assert LO.ADAPTER_KEY in params
    base_params = {k: v for k, v in params.items() if k != LO.ADAPTER_KEY}
    want_params = base.init(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(base_params),
                                                 tree_leaves(want_params)))
    toks = _tokens(base.cfg.vocab)
    want = _apply(base, base_params, toks)
    assert torch.equal(_apply(lm, params, toks), want)
    tr, total = LO.n_trainable(params)
    assert 0 < tr < total


def test_lora_merge_matches_adapter_forward_bitwise(qwen):
    lm, params = qwen["lm"], qwen["params"]
    toks = _tokens(lm.cfg.vocab)
    merged = lm.merge(params)
    assert LO.ADAPTER_KEY not in merged
    got = _apply(lm, params, toks)
    assert torch.equal(_apply(lm.base, merged, toks), got)
    base_params = {k: v for k, v in params.items() if k != LO.ADAPTER_KEY}
    assert not torch.equal(_apply(lm.base, base_params, toks), got)


def test_lora_adapter_ckpt_roundtrip_and_merged_export(tmp_path, qwen):
    """save_adapter -> load_adapter into a fresh init reproduces the adapter
    forward bitwise; ``export.npz`` of export_merged, read back and
    restacked, is ``merge(params)`` bitwise."""
    lm, params = qwen["lm"], qwen["params"]
    d = str(tmp_path / "adapter")
    LO.save_adapter(d, 7, params, extra={"rank": 4})
    fresh = lm.init(torch.Generator().manual_seed(5))
    restored = LO.load_adapter(dict(fresh, **{
        k: v for k, v in params.items() if k != LO.ADAPTER_KEY}), d)
    toks = _tokens(lm.cfg.vocab)
    assert torch.equal(_apply(lm, restored, toks), _apply(lm, params, toks))
    assert read_manifest(os.path.join(d, "step_00000007"))["adapter_only"]

    out = LO.export_merged(lm, params, str(tmp_path / "merged"))
    flat = np.load(out)
    merged = params_to_numpy(lm.merge(params))
    for path, want in flatten_with_paths(merged):
        parts = path.split("/")
        if parts[0] == "blocks":
            got = np.stack([flat[f"model.blocks.{i}.{'.'.join(parts[1:])}"]
                            for i in range(want.shape[0])])
        else:
            got = flat[f"model.{'.'.join(parts)}"]
        assert np.array_equal(got, want), path


def test_frozen_base_optimizer_pins_base():
    """Weight decay 0.1 moves every matrix leaf in plain AdamW; the wrapper
    keeps every frozen param bitwise still and its m and v exact zeros."""
    lm = LO.LoRAModel(build_model(get_reduced(QWEN)), LO.LoRAConfig(rank=4))
    params = lm.init(torch.Generator().manual_seed(0))
    before = tree_map(torch.clone, params)
    opt = LO.FrozenBaseOptimizer(AdamW(lr=1e-2, weight_decay=0.1))
    state = opt.init(params)
    grads = tree_map(torch.ones_like, params)
    new_params, new_state = opt.update(grads, state, params)
    for path, leaf in flatten_with_paths(new_params):
        old = _get(before, path)
        if LO.is_adapter_path(path):
            assert not torch.equal(leaf, old), path
        else:
            assert torch.equal(leaf, old), path
            assert not bool(_get(new_state["m"], path).any())
            assert not bool(_get(new_state["v"], path).any())
    assert int(new_state["count"]) == 1
    assert set(new_state) == {"m", "v", "count"}


@pytest.mark.parametrize("master", [False, True])
def test_frozen_base_optimizer_update_matches_jax(qwen, master):
    """Three updates with ``grad_clip`` active (the full tree's norm is
    about 30x the clip) on the same gradients: adapters, their m and v
    within ADAM_TOL of JAX's; base params and masters unchanged, base m
    and v exact zeros; ``count`` equal."""
    rng = np.random.default_rng(4)
    jp = qwen["jp"]
    grads = [jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), jp)
        for _ in range(3)]
    kw = dict(lr=1e-2, weight_decay=0.1, grad_clip=1.0, master_weights=master)
    jopt = JLO.FrozenBaseOptimizer(JaxAdamW(**kw))
    popt = LO.FrozenBaseOptimizer(AdamW(**kw))
    cast = (lambda a: a.astype(jnp.bfloat16)) if master else jnp.asarray
    jparams = jax.tree_util.tree_map(cast, jp)
    pparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    base0 = params_to_numpy(pparams)
    js, ps = jopt.init(jparams), popt.init(pparams)
    jupdate = jax.jit(jopt.update)
    for g in grads:
        jparams, js = jupdate(jax.tree_util.tree_map(jnp.asarray, g), js,
                              jparams)
        pparams, ps = popt.update(tree_map(torch.as_tensor, g), ps, pparams)
    assert int(ps["count"]) == int(js["count"]) == 3
    trees = [("params", jparams, pparams), ("m", js["m"], ps["m"]),
             ("v", js["v"], ps["v"])]
    if master:
        trees.append(("master", js["master"], ps["master"]))
    for name, jt, pt in trees:
        want = dict(flatten_with_paths(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), jt)))
        for path, leaf in flatten_with_paths(params_to_numpy(pt)):
            if LO.is_adapter_path(path):
                tol = ADAM_TOL + (2e-2 if master and name == "params" else 0)
                np.testing.assert_allclose(leaf, want[path], atol=tol, rtol=0,
                                           err_msg=f"{name}/{path}")
            elif name in ("m", "v"):
                assert not leaf.any(), f"{name}/{path}"
                assert not want[path].any(), f"jax {name}/{path}"
            else:
                assert np.array_equal(leaf, _get(base0, path)), path


def test_train_step_differentiates_the_adapters_only(qwen):
    """Under ``FrozenBaseOptimizer`` the step takes gradients of the
    adapters alone: the same values as the full backward's adapter
    gradients, bitwise."""
    lm, params = qwen["lm"], qwen["params"]
    toks = _tokens(lm.cfg.vocab, s=16)
    batch = {"tokens": torch.as_tensor(toks),
             "labels": torch.as_tensor(np.roll(toks, -1, 1))}

    class Capture:
        def __init__(self, trainable=None):
            if trainable is not None:
                self.trainable = trainable

        def update(self, grads, state, p):
            self.grads = grads
            return p, state

    full, only = Capture(), Capture(LO.is_adapter_path)
    state = {"params": params, "opt": {}, "step": torch.zeros((), dtype=torch.int32)}
    m1 = PST.make_train_step(lm, full)(state, batch)[1]
    m2 = PST.make_train_step(lm, only)(state, batch)[1]
    assert float(m1["loss"]) == float(m2["loss"])
    assert list(only.grads) == [LO.ADAPTER_KEY]
    for (pa, a), (pb, b) in zip(flatten_with_paths(only.grads),
                                flatten_with_paths(
                                    {LO.ADAPTER_KEY: full.grads[LO.ADAPTER_KEY]})):
        assert pa == pb and torch.equal(a, b), pa


# ---------------------------------------------------------------------------
# adapter checkpoints across the packages
# ---------------------------------------------------------------------------
def test_save_adapter_files_equal_jax_and_load_across(tmp_path, qwen):
    extra = {"rank": 4, "alpha": 16.0, "targets": ["wq", "wo"],
             "fingerprint": "sha256:" + "cd" * 32}
    pdir = LO.save_adapter(str(tmp_path / "port"), 3, qwen["params"], extra)
    jdir = JLO.save_adapter(str(tmp_path / "jax"), 3,
                            jax.tree_util.tree_map(jnp.asarray, qwen["jp"]),
                            extra)
    names = []
    for root, _, files in os.walk(jdir):
        for fn in files:
            rel = os.path.relpath(os.path.join(root, fn), jdir)
            names.append(rel)
            with open(os.path.join(jdir, rel), "rb") as a, \
                    open(os.path.join(pdir, rel), "rb") as b:
                assert a.read() == b.read(), rel
    assert sorted(names) == sorted(
        os.path.relpath(os.path.join(r, f), pdir)
        for r, _, fs in os.walk(pdir) for f in fs)
    # each package's load_adapter reads the other's
    fresh = qwen["lm"].init(torch.Generator().manual_seed(9))
    got = LO.load_adapter(fresh, jdir)[LO.ADAPTER_KEY]
    want = dict(flatten_with_paths(qwen["params"][LO.ADAPTER_KEY]))
    assert all(torch.equal(a, want[p]) for p, a in flatten_with_paths(got))
    jfresh = jax.jit(qwen["jlm"].init)(jax.random.PRNGKey(9))
    jgot = JLO.load_adapter(jfresh, pdir)[JLO.ADAPTER_KEY]
    for (p, a), (_, b) in zip(
            flatten_with_paths(jax.tree_util.tree_map(np.asarray, jgot)),
            flatten_with_paths(qwen["jp"][JLO.ADAPTER_KEY])):
        assert np.array_equal(a, b), p


# ---------------------------------------------------------------------------
# SFT datasets
# ---------------------------------------------------------------------------
SFT_CASES = [dict(pack=True), dict(pack=False), dict(pack=True, eos_id=2),
             dict(pack=False, eos_id=2, shuffle=False)]


@pytest.mark.parametrize("kw", SFT_CASES,
                         ids=["packed", "padded", "packed-eos", "padded-eos"])
def test_packed_sft_dataset_equals_jax(kw):
    ex = SFT.synthetic_sft_examples(40, 512, seed=3, prompt_len=(2, 9),
                                    response_len=(3, 20))
    jex = JSFT.synthetic_sft_examples(40, 512, seed=3, prompt_len=(2, 9),
                                      response_len=(3, 20))
    assert all(np.array_equal(a, b) for x, y in zip(ex, jex)
               for a, b in zip(x, y))
    ours = SFT.PackedSFTDataset(ex, seq_len=16, seed=5, **kw)
    theirs = JSFT.PackedSFTDataset(jex, seq_len=16, seed=5, **kw)
    assert len(ours) == len(theirs) > 4
    idx = np.arange(3, 3 + 2 * len(ours))
    a, b = ours.sample_batch(idx), theirs.sample_batch(idx)
    assert list(a) == list(b) == ["tokens", "labels", "loss_mask"]
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    # the mask moves with the labels: the prediction of a prompt token is
    # never scored
    one = ours.sample(0)
    assert set(np.unique(one["loss_mask"])) <= {0.0, 1.0}


def test_sft_synthetic_component_equals_jax():
    from repro.config.registry import DEFAULT_REGISTRY as JREG
    from repro_torch.config.registry import DEFAULT_REGISTRY as REG
    from repro_torch.core.components import register_all

    register_all()
    kw = dict(seq_len=24, vocab=512, n_examples=64, seed=2, eos_id=1,
              prompt_len=[3, 6], response_len=[5, 9])
    ours = REG.build("dataset", "sft_synthetic", **kw)
    theirs = JREG.build("dataset", "sft_synthetic", **kw)
    assert np.array_equal(ours.rows, theirs.rows)
    assert np.array_equal(ours.row_mask, theirs.row_mask)
    assert np.array_equal(ours.order, theirs.order)


def test_sft_jsonl_is_refused_naming_a11(tmp_path):
    """The data pipeline (A11) is ported: ``dataset/sft_jsonl`` over
    ``tokenizer/byte`` builds, its rows ``==`` JAX's."""
    from repro.config.registry import DEFAULT_REGISTRY as JREG
    from repro_torch.config.registry import DEFAULT_REGISTRY as REG
    from repro_torch.core.components import register_all

    register_all()
    (tmp_path / "x.jsonl").write_text(
        '{"prompt": "say hi", "response": "hi"}\n'
        '{"prompt": "count", "response": "one two three"}\n')
    kw = dict(path=str(tmp_path / "x.jsonl"), seq_len=8)
    ours = REG.build("dataset", "sft_jsonl",
                     tokenizer=REG.build("tokenizer", "byte"), **kw)
    theirs = JREG.build("dataset", "sft_jsonl",
                        tokenizer=JREG.build("tokenizer", "byte"), **kw)
    assert np.array_equal(ours.rows, theirs.rows)
    assert np.array_equal(ours.row_mask, theirs.row_mask)


# ---------------------------------------------------------------------------
# settings
# ---------------------------------------------------------------------------
BAD_SETTINGS = [
    ("sft", {"lora": {"rank": 0}}),
    ("sft", {"lora": {"targets": []}}),
    ("sft", {"lora": {"targets": [3]}}),
    ("sft", {"lora": {"ranks": 4}}),
    ("sft", {"resume": "latest"}),
    ("sft", {"resume": "auto", "warmstart": {"source": "x"}}),
    ("dpo", {"resume": "auto"}),
    ("dpo", {"beta": 0.0}),
    ("dpo", {"onpolicy": {"temperature": 0.0}}),
    ("dpo", {"onpolicy": {"n_prompts": 0}}),
]


@pytest.mark.parametrize("kind,settings", BAD_SETTINGS,
                         ids=[f"{k}-{json.dumps(s)[:24]}"
                              for k, s in BAD_SETTINGS])
def test_post_training_settings_errors_equal_jax(kind, settings):
    doc = {"run": {"kind": kind, kind: settings}}
    with pytest.raises(RunError) as ours:
        parse_run_doc(doc)
    with pytest.raises(JaxRunError) as theirs:
        jax_parse_run_doc(doc)
    assert str(ours.value) == str(theirs.value)


def test_sft_and_dpo_documents_normalize_as_jax():
    """The normalized run sections (every setting filled) are JAX's."""
    for name in ("sft", "dpo"):
        path = os.path.join(ROOT, "examples", "configs", f"{name}.yaml")
        from repro.config.resolver import load_yaml as jax_load_yaml
        from repro_torch.config.resolver import load_yaml

        ours = parse_run_doc(load_yaml(path), default_name=name)
        theirs = jax_parse_run_doc(jax_load_yaml(path), default_name=name)
        assert ours.doc["run"] == theirs.doc["run"]


# ---------------------------------------------------------------------------
# the sft kind
# ---------------------------------------------------------------------------
def _sft_doc(tmp_path, name, steps, *, warmstart=None, lora=None,
             resume=None, ckpt_every=0, kind="sft", **extra):
    """``tests/test_posttrain.py``'s document (reduced Qwen, 64 synthetic
    examples of 24 tokens, batch 4)."""
    settings = {"steps": steps, **extra}
    for key, val in (("warmstart", warmstart), ("lora", lora),
                     ("resume", resume)):
        if val is not None:
            settings[key] = val
    gym_cfg = {"model": {"instance_key": "model"},
               "optimizer": {"instance_key": "optimizer"},
               "loader": {"instance_key": "loader"},
               "log_every": 1, "prefetch": 0}
    if ckpt_every:
        gym_cfg["ckpt_every"] = ckpt_every
    return {
        "run": {"kind": kind, "name": name,
                "output_dir": str(tmp_path / name), kind: settings},
        "arch": {"component_key": "arch_config", "variant_key": QWEN,
                 "config": {"reduced": True}},
        "model": {"component_key": "model", "variant_key": "auto",
                  "config": {"arch_config": {"instance_key": "arch"}}},
        "optimizer": {"component_key": "optimizer", "variant_key": "adamw",
                      "config": {"lr": 0.002, "weight_decay": 0.0}},
        "dataset": {"component_key": "dataset", "variant_key": "sft_synthetic",
                    "config": {"seq_len": 24, "vocab": 512, "n_examples": 64,
                               "seed": 0}},
        "loader": {"component_key": "loader", "variant_key": "sharded",
                   "config": {"dataset": {"instance_key": "dataset"},
                              "global_batch": 4}},
        "gym": {"component_key": "gym", "variant_key": "standard",
                "config": gym_cfg},
    }


def _port(doc, **kw):
    return api.execute_doc(doc, device="cpu", log=_quiet, **kw)


def _ckpt_leaves(ckpt):
    _, d = latest_checkpoint(ckpt)
    return {k: read_leaf(d, e) for k, e in read_manifest(d)["leaves"].items()}


def test_sft_warmstart_keeps_base_bitwise(tmp_path):
    """A strict warmstart from an adapter-less donor (the port's train
    run) keeps fresh adapters, and after training the sft checkpoint's
    base leaves are bitwise the donor's; the adapter checkpoint holds the
    adapters alone."""
    donor = _sft_doc(tmp_path, "donor", 2, ckpt_every=2, kind="train")
    _port(donor, write_result=True)
    src = str(tmp_path / "donor" / "ckpt")
    logs = []
    res = api.execute_doc(
        _sft_doc(tmp_path, "sft", 3, lora={"rank": 4}, ckpt_every=3,
                 warmstart={"source": src, "strict": True}),
        device="cpu", log=logs.append, write_result=True)
    assert any("donor has no adapters" in m for m in logs)
    assert any(m.startswith("lora: rank 4") for m in logs)
    assert res["lora"]["rank"] == 4 and res["history"][-1]["loss"] > 0
    donor_leaves = _ckpt_leaves(src)
    sft = _ckpt_leaves(str(tmp_path / "sft" / "ckpt"))
    checked = 0
    for key, val in sft.items():
        if key.startswith("params/") and not LO.is_adapter_path(
                key.split("/", 1)[1]):
            assert torch.equal(val, donor_leaves[key]), key
            checked += 1
    assert checked > 3
    adapter = read_manifest(res["adapter_ckpt"])
    assert adapter["adapter_only"] and adapter["rank"] == 4
    assert all(k.startswith("params/lora/") for k in adapter["leaves"])


def test_sft_resume_matches_straight(tmp_path):
    straight = _port(_sft_doc(tmp_path, "straight", 4, lora={"rank": 4},
                              ckpt_every=2))
    _port(_sft_doc(tmp_path, "resumed", 2, lora={"rank": 4}, ckpt_every=2))
    resumed = _port(_sft_doc(tmp_path, "resumed", 4, lora={"rank": 4},
                             ckpt_every=2, resume="auto"))
    assert resumed["resumed_from"] == 2
    want = {m["step"]: m["loss"] for m in straight["history"]}
    got = {m["step"]: m["loss"] for m in resumed["history"]}
    assert sorted(got) == [3, 4]
    assert all(got[s] == want[s] for s in got)


def test_sft_masked_loss_decreases_and_full_parameter_mode(tmp_path):
    res = _port(_sft_doc(tmp_path, "learn", 12, lora={"rank": 8}))
    assert res["final_loss"] < res["first_loss"] - 0.05
    full = _port(_sft_doc(tmp_path, "fullft", 2), write_result=True)
    assert full["lora"] is None and "adapter_ckpt" not in full


@pytest.fixture(scope="module")
def jax_sft_donor(tmp_path_factory):
    """A JAX ``sft`` run of 2 steps with a checkpoint at 2: its params and
    optimizer state carry adapters."""
    tmp = tmp_path_factory.mktemp("jax_sft")
    jax_api.execute_doc(_sft_doc(tmp, "jsft", 2, lora={"rank": 4},
                                 ckpt_every=2))
    return str(tmp / "jsft" / "ckpt")


def test_sft_carry_from_jax_checkpoint_matches_jax(tmp_path, jax_sft_donor):
    """Both packages warmstart ``carry`` from JAX's sft checkpoint (the
    donor's adapters restored strictly, m/v/count carried) for 2 sft
    steps: the losses agree within CURVE_TOL."""
    ws = {"source": jax_sft_donor, "optimizer": "carry", "strict": True}
    assert any(LO.is_adapter_path(k.split("/", 1)[1])
               for k in JEL.manifest_keys(jax_sft_donor)
               if k.startswith("params/"))
    doc = _sft_doc(tmp_path, "carry", 2, lora={"rank": 4}, warmstart=ws)
    want = jax_api.execute_doc(doc, write_files=False)
    logs = []
    got = api.execute_doc(doc, device="cpu", log=logs.append)
    assert not any("donor has no adapters" in m for m in logs)
    assert len(got["history"]) == len(want["history"]) == 2
    for a, b in zip(got["history"], want["history"]):
        assert abs(a["loss"] - b["loss"]) <= CURVE_TOL, (a, b)
    assert EL.manifest_keys(jax_sft_donor) >= {"opt/count"}


def test_sft_cli_runs_the_document(tmp_path, capsys):
    """``python -m repro_torch sft`` on ``sft.yaml`` unchanged but for its
    output directory, its donor and its length, after the command in its
    header (the quickstart with ``ckpt_every``)."""
    q = os.path.join(ROOT, "examples", "configs", "quickstart.yaml")
    data = f"dataset.config.prefix={tmp_path / 'qs'}"
    assert cli_main(["train", "--config", q, "--device", "cpu", "--set", data,
                     "--set", "run.train.steps=4", "--set",
                     "gym.config.ckpt_every=4", "--set",
                     f"run.output_dir={tmp_path / 'quickstart'}"]) == 0
    assert cli_main([
        "sft", "--config", SFT_YAML, "--device", "cpu",
        "--set", f"run.sft.warmstart.source={tmp_path / 'quickstart' / 'ckpt'}",
        "--set", "run.sft.steps=3", "--set", "run.sft.export_merged=true",
        "--set", f"run.output_dir={tmp_path / 'sft'}"]) == 0
    out = capsys.readouterr().out
    assert "done: 3 logged points" in out
    with open(tmp_path / "sft" / "result.json") as f:
        res = json.load(f)
    assert res["kind"] == "sft" and res["merged_export"].endswith("export.npz")
    assert os.path.isdir(res["adapter_ckpt"])
