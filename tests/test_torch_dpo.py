"""The port's DPO (``repro_torch.posttrain.dpo`` and the ``dpo`` kind)
against the JAX package's, on the CPU, on reduced Qwen1.5-0.5B with LoRA.
Inputs are numpy arrays from a seed; JAX's params (with non-zero ``b``
factors, so policy and reference differ) are carried across by
``repro_torch.bridge``.

Tolerances:

- the datasets' batches and the on-policy pairs' prompts are ``==``; each
  sampled completion equals JAX's or parts from it at a near-tie, where
  JAX's sampler draws the port's token once each of JAX's logits moves by
  at most ``LOGIT_TOL`` 3e-2 (``tests/test_torch_engine.py``);
- one ``make_dpo_step`` with f32 activations: the per-sequence log-probs
  sum about twenty f32 log-softmax values of logits that agree to 1e-6
  (``tests/test_torch_posttrain.py``), so the logps and the margin agree to
  ``LOGP_TOL`` 1e-4 (1e-5 seen); the loss to ``STEP_F32_LOSS_TOL`` 1e-6 of
  itself and the adapter gradients to ``STEP_F32_TOL`` 1e-4 of each leaf's
  largest (``tests/test_torch_train.py``: f32 sums in other orders);
- the ``dpo`` kind, warmstarted with ``carry`` from one JAX ``sft``
  checkpoint in both packages (bf16 activations): ``MARGIN_TOL`` 0.1 on the
  margins, which sum bf16-rounded log-probs over ~20 tokens four times
  (1.9e-2 seen at the second step), and ``DPO_LOSS_TOL`` 5e-3 on the
  losses: near a margin of 0 the loss moves by ``beta / 2`` per unit of
  margin, so the margin bound allows 5e-3 (1.0e-3 seen).
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
from repro.configs import get_reduced as jax_get_reduced
from repro.core.gym import Gym as JaxGym
from repro.models import build_model as jax_build_model
from repro.posttrain import dpo as JDPO
from repro.posttrain import lora as JLO
from repro.run import api as jax_api
from repro.serve.sampling import sample_tokens as jax_sample_tokens
from repro_torch.bridge import params_from_jax
from repro_torch.ckpt.format import flatten_with_paths
from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.posttrain import dpo as DPO
from repro_torch.posttrain import lora as LO
from repro_torch.run import api
from repro_torch.run.cli import main as cli_main
from repro_torch.tree import tree_map

ROOT = os.path.join(os.path.dirname(__file__), "..")
DPO_YAML = os.path.join(ROOT, "examples", "configs", "dpo.yaml")
LOGIT_TOL = 3e-2            # tests/test_torch_engine.py
LOGP_TOL = 1e-4
STEP_F32_LOSS_TOL = 1e-6    # tests/test_torch_train.py
STEP_F32_TOL = 1e-4         # tests/test_torch_train.py
MARGIN_TOL = 0.1
DPO_LOSS_TOL = 5e-3
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


@pytest.fixture(scope="module")
def qwen():
    """Reduced Qwen with LoRA rank 4 in both packages, on JAX's init with
    non-zero ``b`` factors (numpy) and the port's copy of it."""
    jlm = JLO.LoRAModel(jax_build_model(jax_get_reduced(QWEN)),
                        JLO.LoRAConfig(rank=4))
    jp = jax.tree_util.tree_map(np.asarray,
                                jax.jit(jlm.init)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    jp[JLO.ADAPTER_KEY] = jax.tree_util.tree_map(
        lambda x: x + (0.02 * rng.standard_normal(x.shape)).astype(x.dtype),
        jp[JLO.ADAPTER_KEY])
    lm = LO.LoRAModel(build_model(get_reduced(QWEN)), LO.LoRAConfig(rank=4))
    return {"jlm": jlm, "lm": lm, "jp": jp, "params": params_from_jax(jp)}


# ---------------------------------------------------------------------------
# preference datasets
# ---------------------------------------------------------------------------
def test_preference_pair_dataset_equals_jax():
    pairs = DPO.synthetic_preference_pairs(24, 512, seed=3, prompt_len=(2, 9),
                                           response_len=(4, 30))
    jpairs = JDPO.synthetic_preference_pairs(24, 512, seed=3,
                                             prompt_len=(2, 9),
                                             response_len=(4, 30))
    assert all(np.array_equal(a, b) for x, y in zip(pairs, jpairs)
               for a, b in zip(x, y))
    ours = DPO.PreferencePairDataset(pairs, seq_len=24, pad_id=1, seed=4)
    theirs = JDPO.PreferencePairDataset(jpairs, seq_len=24, pad_id=1, seed=4)
    idx = np.arange(5, 5 + 2 * len(ours))
    a, b = ours.sample_batch(idx), theirs.sample_batch(idx)
    assert list(a) == list(b) == list(DPO.PREF_KEYS)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    # a completion longer than the row is truncated, never packed across
    assert a["chosen_tokens"].shape == (len(idx), 24)


def test_preference_synthetic_component_equals_jax():
    from repro.config.registry import DEFAULT_REGISTRY as JREG
    from repro_torch.config.registry import DEFAULT_REGISTRY as REG
    from repro_torch.core.components import register_all

    register_all()
    kw = dict(seq_len=32, vocab=512, n_pairs=40, seed=6,
              response_len=[8, 16])
    ours = REG.build("dataset", "preference_synthetic", **kw)
    theirs = JREG.build("dataset", "preference_synthetic", **kw)
    for name in ("chosen_rows", "chosen_m", "rejected_rows", "rejected_m",
                 "order"):
        assert np.array_equal(getattr(ours, name), getattr(theirs, name))


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
class _Capture:
    """An optimizer that returns the gradients a step hands it as the new
    optimizer state (so they leave a jitted JAX step too)."""

    def __init__(self, trainable=None):
        if trainable is not None:
            self.trainable = trainable

    def update(self, grads, state, params):
        return params, grads


def test_dpo_step_matches_jax(qwen):
    """One step on the same params, reference (the zero-adapter base) and
    batch, with f32 activations in both packages."""
    ds = DPO.preference_synthetic_dataset(24, qwen["lm"].cfg.vocab,
                                          n_pairs=8, seed=2)
    batch = ds.sample_batch(np.arange(4))
    jlm, lm = qwen["jlm"], qwen["lm"]
    jembed, pembed = jlm.base.embed_tokens, lm.base.embed_tokens
    jcap, pcap = _Capture(), _Capture(LO.is_adapter_path)
    with mock.patch.object(jlm.base, "embed_tokens", lambda p, t: jembed(
            p, t, dtype=jnp.float32)), \
            mock.patch.object(lm.base, "embed_tokens", lambda p, t: pembed(
                p, t, dtype=torch.float32)):
        jp = jax.tree_util.tree_map(jnp.asarray, qwen["jp"])
        jstate, jm = jax.jit(JDPO.make_dpo_step(jlm, jcap, beta=0.1))(
            {"params": jp, "opt": {}, "step": jnp.int32(0)},
            {k: jnp.asarray(v) for k, v in batch.items()},
            JLO.zero_adapters(jp))
        params = qwen["params"]
        ref = tree_map(torch.clone, LO.zero_adapters(params))
        state, pm = DPO.make_dpo_step(lm, pcap, beta=0.1)(
            {"params": params, "opt": {},
             "step": torch.zeros((), dtype=torch.int32)},
            {k: torch.as_tensor(v) for k, v in batch.items()}, ref)
    assert int(state["step"]) == 1
    assert set(pm) == set(jm) == {"loss", "margin", "reward_accuracy",
                                  "logp_chosen", "logp_rejected"}
    assert abs(float(pm["loss"]) - float(jm["loss"])) <= \
        STEP_F32_LOSS_TOL * float(jm["loss"])
    for k in ("margin", "logp_chosen", "logp_rejected"):
        assert abs(float(pm[k]) - float(jm[k])) <= LOGP_TOL, k
    assert float(pm["reward_accuracy"]) == float(jm["reward_accuracy"])
    assert abs(float(pm["margin"])) > 10 * LOGP_TOL   # the adapters matter
    want = dict(flatten_with_paths(jax.tree_util.tree_map(
        np.asarray, jstate["opt"])))
    assert list(state["opt"]) == [LO.ADAPTER_KEY]
    for path, g in flatten_with_paths(state["opt"]):
        scale = float(np.abs(want[path]).max())
        assert scale > 0, path
        assert float(np.abs(g.numpy() - want[path]).max()) <= \
            STEP_F32_TOL * scale, path
    # JAX zeroes nothing here (its capture sees every leaf): the frozen
    # base gets gradient in JAX, none in the port
    assert any(not LO.is_adapter_path(p) for p in want)


def test_dpo_gym_refusals_equal_jax():
    """``grad_accum > 1`` and an unset reference raise JAX's errors
    (``_build_step`` called with JAX's signature)."""
    ours = DPO.DPOGym(model=None, optimizer=None, loader=None, grad_accum=2)
    theirs = JDPO.DPOGym(model=None, optimizer=None, loader=None,
                         grad_accum=2)
    with pytest.raises(NotImplementedError) as a:
        ours._build_step(None, ())
    with pytest.raises(NotImplementedError) as b:
        theirs._build_step(None, ())
    assert str(a.value) == str(b.value)
    with pytest.raises(RuntimeError) as a:
        ours._step_extra_args()
    with pytest.raises(RuntimeError) as b:
        theirs._step_extra_args()
    assert str(a.value) == str(b.value)
    assert issubclass(JDPO.DPOGym, JaxGym)


# ---------------------------------------------------------------------------
# on-policy pairs
# ---------------------------------------------------------------------------
def _jax_paged_logits(jm, jp, prompt, gen, bl, C, max_len):
    """JAX's logits for the token after ``prompt + gen``, teacher-forced
    through its paged programs (``tests/test_torch_engine.py``)."""
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
    return np.asarray(logits, np.float32)[0]


def _near_tie(jm, jp, prompt, jax_gen, i, port_tok, seed, temperature,
              max_len):
    """JAX's sampler draws ``port_tok`` once each of JAX's logits moves by
    at most LOGIT_TOL: down for the tokens that beat it, up for the rest."""
    logits = _jax_paged_logits(jm, jp, prompt, jax_gen[:i], 16, 32, max_len)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), i)[None]
    score = logits / temperature + np.asarray(
        jax.random.gumbel(key[0], logits.shape))
    delta = np.where(score > score[port_tok], -LOGIT_TOL, LOGIT_TOL)
    tok = jax_sample_tokens(jnp.asarray(logits + delta)[None], key,
                            jnp.float32([temperature]), jnp.int32([0]),
                            jnp.float32([1.0]))
    return int(tok[0]) == port_tok


def test_sample_onpolicy_pairs_match_jax_or_tie(qwen):
    """Both packages sample 4 prompts x 2 completions through their paged
    engines on the merged params: the prompts ``==``, each completion
    equal to JAX's or parted at a near-tie; the port's pairs are the same
    on a second call with the same seed."""
    kw = dict(vocab=qwen["lm"].cfg.vocab, n_prompts=4, prompt_len=12,
              gen_tokens=8, temperature=0.9, seed=5, n_slots=4)
    jm = qwen["jlm"].base
    jp = qwen["jlm"].merge(jax.tree_util.tree_map(jnp.asarray, qwen["jp"]))
    with torch.no_grad():
        params = qwen["lm"].merge(qwen["params"])
    ours = DPO.sample_onpolicy_pairs(qwen["lm"].base, params, **kw)
    again = DPO.sample_onpolicy_pairs(qwen["lm"].base, params, **kw)
    theirs = JDPO.sample_onpolicy_pairs(jm, jp, **kw)
    assert all(np.array_equal(a, b) for x, y in zip(ours, again)
               for a, b in zip(x, y))
    same = 0
    for i, ((p, c, r), (jp_, jc, jr)) in enumerate(zip(ours, theirs)):
        assert np.array_equal(p, jp_)
        if np.array_equal(c, jc) and np.array_equal(r, jr):
            same += 1
            continue
        # compare the two samples of the prompt in request order: the
        # ranking follows them
        for a in (c, r):
            b = next((x for x in (jc, jr) if x[0] == a[0]), jc)
            if np.array_equal(a, b):
                continue
            j = next(k for k in range(len(a)) if a[k] != b[k])
            seeds = [kw["seed"] * 7919 + 2 * i + s for s in (0, 1)]
            assert any(_near_tie(jm, jp, p, list(b), j, int(a[j]), sd,
                                 kw["temperature"], 20) for sd in seeds), \
                (i, j)
    assert same >= 2


# ---------------------------------------------------------------------------
# the dpo kind
# ---------------------------------------------------------------------------
def _dpo_doc(tmp_path, name, steps, *, lora=None, beta=0.1, onpolicy=None,
             resume=None, ckpt_every=0, seq_len=24, n_pairs=48, batch=4,
             lr=0.002, warmstart=None, kind="dpo", resilience=None):
    """``tests/test_posttrain.py``'s DPO document (reduced Qwen,
    preference_synthetic pairs)."""
    settings = {"steps": steps}
    if kind == "dpo":
        settings["beta"] = beta
    for key, val in (("lora", lora), ("onpolicy", onpolicy),
                     ("resume", resume), ("warmstart", warmstart),
                     ("resilience", resilience)):
        if val is not None:
            settings[key] = val
    gym_cfg = {"model": {"instance_key": "model"},
               "optimizer": {"instance_key": "optimizer"},
               "loader": {"instance_key": "loader"},
               "log_every": 1, "prefetch": 0}
    if ckpt_every:
        gym_cfg["ckpt_every"] = ckpt_every
    dataset = ({"component_key": "dataset", "variant_key": "sft_synthetic",
                "config": {"seq_len": seq_len, "vocab": 512, "n_examples": 64,
                           "seed": 0}} if kind == "sft" else
               {"component_key": "dataset",
                "variant_key": "preference_synthetic",
                "config": {"seq_len": seq_len, "vocab": 512,
                           "n_pairs": n_pairs, "seed": 0}})
    return {
        "run": {"kind": kind, "name": name,
                "output_dir": str(tmp_path / name), kind: settings},
        "arch": {"component_key": "arch_config", "variant_key": QWEN,
                 "config": {"reduced": True}},
        "model": {"component_key": "model", "variant_key": "auto",
                  "config": {"arch_config": {"instance_key": "arch"}}},
        "optimizer": {"component_key": "optimizer", "variant_key": "adamw",
                      "config": {"lr": lr, "weight_decay": 0.0}},
        "dataset": dataset,
        "loader": {"component_key": "loader", "variant_key": "sharded",
                   "config": {"dataset": {"instance_key": "dataset"},
                              "global_batch": batch}},
        "gym": {"component_key": "gym", "variant_key": "standard",
                "config": gym_cfg},
    }


def _port(doc, **kw):
    return api.execute_doc(doc, device="cpu", log=_quiet, **kw)


def test_dpo_margin_increases(tmp_path):
    """The first loss is log 2 and the first margin 0 (policy and reference
    compute one function: b = 0), and margins rise on the synthetic
    preference set (``tests/test_posttrain.py``'s run)."""
    res = _port(_dpo_doc(tmp_path, "dpo", 10, lora={"rank": 8}, seq_len=32,
                         n_pairs=64, batch=8, lr=0.001), write_result=True)
    assert abs(res["history"][0]["loss"] - float(np.log(2))) < 1e-6
    assert res["first_margin"] == 0.0
    assert res["final_margin"] > 0.5
    assert res["final_reward_accuracy"] >= 0.75
    assert res["adapter_ckpt"] and res["beta"] == 0.1
    assert res["model_flops_per_step"] > 0


def test_dpo_reference_survives_nan_params_and_rollback(tmp_path):
    """``nan_params`` multiplies the policy's params by NaN in place and the
    sentinel rolls back to the step-1 checkpoint: a reference that aliased
    the policy would be NaN for the replayed steps.  The curve is the clean
    run's, ``==``."""
    clean = _port(_dpo_doc(tmp_path, "clean", 4, lora={"rank": 4},
                           ckpt_every=1))
    chaos = _port(_dpo_doc(
        tmp_path, "chaos", 4, lora={"rank": 4}, ckpt_every=1,
        resilience={"sentinel": True,
                    "faults": [{"kind": "nan_params", "at": 3}]}))
    assert chaos["rollback_count"] == 1
    want = [(m["loss"], m["margin"]) for m in clean["history"]]
    got = [(m["loss"], m["margin"]) for m in chaos["history"]]
    assert got == want and all(np.isfinite(got).ravel())


def test_dpo_resume_with_lora_matches_straight(tmp_path):
    straight = _port(_dpo_doc(tmp_path, "straight", 4, lora={"rank": 4},
                              ckpt_every=2))
    _port(_dpo_doc(tmp_path, "resumed", 2, lora={"rank": 4}, ckpt_every=2))
    resumed = _port(_dpo_doc(tmp_path, "resumed", 4, lora={"rank": 4},
                             ckpt_every=2, resume="auto"))
    assert resumed["resumed_from"] == 2
    want = {m["step"]: (m["loss"], m["margin"]) for m in straight["history"]}
    assert {m["step"]: (m["loss"], m["margin"])
            for m in resumed["history"]} == {s: want[s] for s in (3, 4)}


def test_dpo_onpolicy_sampling(tmp_path):
    """On-policy mode samples its pairs through the engine and trains on
    them (the margin moves off zero); full-parameter DPO runs without a
    ``lora`` block."""
    res = _port(_dpo_doc(
        tmp_path, "dpo_op", 3, lora={"rank": 4},
        onpolicy={"n_prompts": 4, "prompt_len": 8, "gen_tokens": 8,
                  "temperature": 0.9, "n_slots": 4}))
    assert res["final_margin"] != res["first_margin"] == 0.0
    full = _port(_dpo_doc(tmp_path, "dpo_full", 2))
    assert full["lora"] is None and full["first_margin"] == 0.0


@pytest.fixture(scope="module")
def jax_sft_donor(tmp_path_factory):
    """A JAX ``sft`` run of 2 steps with a checkpoint at 2 (adapters
    trained, so policy and reference differ from the first DPO step)."""
    tmp = tmp_path_factory.mktemp("jax_sft")
    jax_api.execute_doc(_dpo_doc(tmp, "jsft", 2, lora={"rank": 4},
                                 ckpt_every=2, kind="sft"))
    return str(tmp / "jsft" / "ckpt")


def test_dpo_carry_from_jax_sft_checkpoint_matches_jax(tmp_path,
                                                        jax_sft_donor):
    ws = {"source": jax_sft_donor, "optimizer": "carry", "strict": True}
    doc = _dpo_doc(tmp_path, "carry", 2, lora={"rank": 4}, warmstart=ws)
    want = jax_api.execute_doc(doc, write_files=False)
    got = _port(doc)
    assert len(got["history"]) == len(want["history"]) == 2
    for a, b in zip(got["history"], want["history"]):
        assert abs(a["loss"] - b["loss"]) <= DPO_LOSS_TOL, (a, b)
        assert abs(a["margin"] - b["margin"]) <= MARGIN_TOL, (a, b)
        assert a["reward_accuracy"] == b["reward_accuracy"]


def test_dpo_cli_runs_the_document(tmp_path, capsys):
    """``python -m repro_torch dpo`` on ``dpo.yaml`` unchanged but for its
    output directory and its length."""
    assert cli_main(["dpo", "--config", DPO_YAML, "--device", "cpu",
                     "--set", "run.dpo.steps=2",
                     "--set", f"run.output_dir={tmp_path / 'dpo'}"]) == 0
    out = capsys.readouterr().out
    assert "done: 2 logged points; first loss 0.6931" in out
    assert "dpo: margin 0.0000 ->" in out
    with open(tmp_path / "dpo" / "result.json") as f:
        res = json.load(f)
    assert res["kind"] == "dpo" and res["lora"]["rank"] == 8
