"""Direct Preference Optimization (port of ``repro.posttrain.dpo``): step
builder, preference datasets, and the :class:`DPOGym` variant that drives
them through the shared gym loop.

The DPO loss compares the *policy* and a *frozen reference* on
chosen/rejected completion pairs::

    loss = -log sigmoid(beta * ((pol_c - ref_c) - (pol_r - ref_r)))

where each term is a masked sum of per-token gold logprobs over the
response region, from an f32 log-softmax over the full vocabulary.  The
reference params are a step argument, run under ``torch.no_grad()``; they
must be a *copy*, never an alias of the policy's tensors: the step updates
those in place (AdamW), fault injection corrupts them in place and a
rollback restores a new tree.  Under LoRA the reference is free: zeroed
adapters make the merged forward the frozen base
(:func:`repro_torch.posttrain.lora.zero_adapters`), so resume and warmstart
can always rebuild it.

Preference pairs come from two sources: static (synthetic or user-built
``(prompt, chosen, rejected)`` triples, numpy only, so the rows are JAX's
bit for bit) or *on-policy* — two sampled completions per prompt through
the continuous-batching :class:`~repro_torch.serve.engine.ServeEngine`,
ranked by a score function.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.gym import Gym

Pair = Tuple[np.ndarray, np.ndarray, np.ndarray]   # (prompt, chosen, rejected)

#: batch keys a preference batch must carry (each [B, S], masks f32)
PREF_KEYS = ("chosen_tokens", "chosen_labels", "chosen_mask",
             "rejected_tokens", "rejected_labels", "rejected_mask")


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------
def _pref_row(prompt: np.ndarray, completion: np.ndarray, width: int,
              pad_id: int) -> Tuple[np.ndarray, np.ndarray]:
    """One padded ``[width]`` row + response mask (over the full row; the
    caller shifts both into tokens/labels/mask)."""
    t = np.concatenate([prompt, completion]).astype(np.int32)[:width]
    m = np.concatenate([np.zeros(len(prompt), np.float32),
                        np.ones(len(completion), np.float32)])[:width]
    pad = width - len(t)
    if pad:
        t = np.concatenate([t, np.full(pad, pad_id, np.int32)])
        m = np.concatenate([m, np.zeros(pad, np.float32)])
    return t, m


@dataclasses.dataclass
class PreferencePairDataset:
    """Static ``(prompt, chosen, rejected)`` triples -> DPO dict batches.

    Rows are padded (never packed — the pairwise loss needs example
    boundaries), and ``sample_batch`` returns the six :data:`PREF_KEYS`
    arrays, so the loader's vectorized dict path carries the whole pair."""

    pairs: Sequence[Pair]
    seq_len: int
    pad_id: int = 0
    seed: int = 0
    shuffle: bool = True

    vectorized = True

    def __post_init__(self):
        if not self.pairs:
            raise ValueError("PreferencePairDataset needs at least one pair")
        w = self.seq_len + 1
        ct, cm, rt, rm = [], [], [], []
        for prompt, chosen, rejected in self.pairs:
            t, m = _pref_row(np.asarray(prompt), np.asarray(chosen), w,
                             self.pad_id)
            ct.append(t)
            cm.append(m)
            t, m = _pref_row(np.asarray(prompt), np.asarray(rejected), w,
                             self.pad_id)
            rt.append(t)
            rm.append(m)
        self.chosen_rows, self.chosen_m = np.stack(ct), np.stack(cm)
        self.rejected_rows, self.rejected_m = np.stack(rt), np.stack(rm)
        self.n_samples = len(self.pairs)
        self.order = np.arange(self.n_samples)
        if self.shuffle:
            np.random.default_rng(self.seed).shuffle(self.order)

    def __len__(self) -> int:
        return self.n_samples

    def sample(self, i: int) -> Dict[str, np.ndarray]:
        return {k: v[0] for k, v in self.sample_batch(np.asarray([i])).items()}

    def sample_batch(self, idxs: np.ndarray) -> Dict[str, np.ndarray]:
        ks = self.order[np.asarray(idxs, np.int64) % max(self.n_samples, 1)]

        def shift(rows, mask):
            return (np.ascontiguousarray(rows[:, :-1]),
                    np.ascontiguousarray(rows[:, 1:]),
                    np.ascontiguousarray(mask[:, 1:]))

        c = shift(self.chosen_rows[ks], self.chosen_m[ks])
        r = shift(self.rejected_rows[ks], self.rejected_m[ks])
        return dict(zip(PREF_KEYS, c + r))


def synthetic_preference_pairs(n_pairs: int, vocab: int, seed: int = 0,
                               prompt_len: Tuple[int, int] = (4, 10),
                               response_len: Tuple[int, int] = (6, 12)
                               ) -> List[Pair]:
    """Seeded pairs with a *learnable* preference: chosen responses count
    up from the prompt's last token (the SFT synthetic target), rejected
    ones are uniform noise — implicit-reward margins must climb."""
    rng = np.random.default_rng(seed)
    lo = min(3, vocab - 1)
    out: List[Pair] = []
    for _ in range(n_pairs):
        p_len = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        r_len = int(rng.integers(response_len[0], response_len[1] + 1))
        prompt = rng.integers(lo, vocab, size=p_len).astype(np.int32)
        start = int(prompt[-1])
        chosen = ((start + 1 + np.arange(r_len)) % (vocab - lo) + lo
                  ).astype(np.int32)
        rejected = rng.integers(lo, vocab, size=r_len).astype(np.int32)
        out.append((prompt, chosen, rejected))
    return out


def preference_synthetic_dataset(seq_len: int, vocab: int,
                                 n_pairs: int = 128, seed: int = 0,
                                 shuffle: bool = True,
                                 prompt_len: Optional[Sequence[int]] = None,
                                 response_len: Optional[Sequence[int]] = None
                                 ) -> PreferencePairDataset:
    pairs = synthetic_preference_pairs(
        n_pairs, vocab, seed=seed,
        prompt_len=tuple(prompt_len or (4, 10)),
        response_len=tuple(response_len or (6, 12)))
    return PreferencePairDataset(pairs, seq_len=seq_len, seed=seed,
                                 shuffle=shuffle)


# ---------------------------------------------------------------------------
# on-policy sampling through the serve engine
# ---------------------------------------------------------------------------
def _ascending_score(prompt: np.ndarray, gen: np.ndarray) -> float:
    """Default ranker matching the synthetic tasks: fraction of adjacent
    generated tokens that count up by one."""
    if len(gen) < 2:
        return 0.0
    return float(np.mean(np.diff(np.asarray(gen)) == 1))


def sample_onpolicy_pairs(model, params, *, vocab: int, n_prompts: int = 8,
                          prompt_len: int = 16, gen_tokens: int = 16,
                          temperature: float = 0.8, top_k: int = 0,
                          top_p: float = 1.0, seed: int = 0,
                          n_slots: int = 4,
                          score_fn: Optional[Callable[..., float]] = None,
                          log: Optional[Callable[[str], None]] = None
                          ) -> List[Pair]:
    """Two sampled completions per prompt through the
    :class:`~repro_torch.serve.engine.ServeEngine` (different per-request
    seeds), ranked into (chosen, rejected) by ``score_fn(prompt, gen) ->
    float``.  Ties keep the first sample as chosen, so the pairing is
    deterministic for a fixed seed — the run stays replayable.  The engine
    runs where ``params`` lie."""
    from ..serve.engine import ServeEngine
    from ..serve.workload import Request

    if temperature <= 0:
        raise ValueError("on-policy DPO sampling needs temperature > 0 "
                         "(greedy would generate identical pairs)")
    rng = np.random.default_rng(seed)
    lo = min(3, vocab - 1)
    prompts = [rng.integers(lo, vocab, size=prompt_len).astype(np.int32)
               for _ in range(n_prompts)]
    requests = [
        Request(rid=2 * i + j, prompt=p, max_new=gen_tokens,
                seed=seed * 7919 + 2 * i + j, temperature=temperature,
                top_k=top_k, top_p=top_p)
        for i, p in enumerate(prompts) for j in (0, 1)
    ]
    engine = ServeEngine(model, params, n_slots=n_slots,
                         max_len=prompt_len + gen_tokens, log=log)
    result = engine.run(requests, realtime=False)
    rows = {row["id"]: row for row in result["requests"]}
    score = score_fn or _ascending_score
    pairs: List[Pair] = []
    for i, p in enumerate(prompts):
        g0 = np.asarray(rows[2 * i]["gen_ids"], np.int32)
        g1 = np.asarray(rows[2 * i + 1]["gen_ids"], np.int32)
        if score(p, g0) >= score(p, g1):
            pairs.append((p, g0, g1))
        else:
            pairs.append((p, g1, g0))
    return pairs


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
def make_dpo_step(model, optimizer, mesh_ctx=None, storage_axes=(),
                  beta: float = 0.1):
    """Returns ``dpo_step(state, batch, ref_params) -> (state, metrics)``.

    Metrics (0-d tensors on the device): ``loss``, implicit-reward
    ``margin`` (mean over the batch), ``reward_accuracy`` (fraction of
    pairs with positive margin), and the raw chosen/rejected policy logprob
    means.  Gradients flow only into the policy's params (its trainable
    leaves where the optimizer has a ``trainable`` predicate); like the
    train step, the state is updated in place.

    Under a mesh (``mesh_ctx``; the state, the reference and the batch
    DTensors laid out by a sharding plan) the forwards run on DTensors as
    the train step's do.  The f32 log-softmax needs the whole vocabulary:
    the logits, whose vocab dim lies over ``model`` under TP, are gathered
    over it and each rank takes its rows' gold logprobs on plain tensors
    (``base.local_call``), the same ops on the same values as with no
    mesh.  Gradients are laid out like their params and the metrics come
    back plain, as in ``train.steps.make_train_step``."""
    from ..models.base import is_dtensor
    from ..train.steps import laid_out, value_and_grad

    trainable = getattr(optimizer, "trainable", None)

    def dpo_loss(margin):
        return -torch.mean(F.logsigmoid(beta * margin))

    def gold_logp(logits, labels, mask):
        lp = torch.log_softmax(logits.float(), dim=-1)
        gold = torch.gather(lp, -1, labels.long()[..., None])[..., 0]
        return torch.sum(gold * mask.float(), dim=-1)          # [B]

    def seq_logp(params, tokens, labels, mask):
        if mesh_ctx is None:
            logits, _ = model.apply(params, {"tokens": tokens})
            return gold_logp(logits, labels, mask)
        logits, _ = model.apply(params, {"tokens": tokens}, mesh_ctx,
                                storage_axes)
        return _rows_call(gold_logp, logits, labels, mask)

    def loss_fn(params, batch, ref_params):
        pol_c = seq_logp(params, batch["chosen_tokens"],
                         batch["chosen_labels"], batch["chosen_mask"])
        pol_r = seq_logp(params, batch["rejected_tokens"],
                         batch["rejected_labels"], batch["rejected_mask"])
        with torch.no_grad():
            ref_c = seq_logp(ref_params, batch["chosen_tokens"],
                             batch["chosen_labels"], batch["chosen_mask"])
            ref_r = seq_logp(ref_params, batch["rejected_tokens"],
                             batch["rejected_labels"], batch["rejected_mask"])
        margin = (pol_c - ref_c) - (pol_r - ref_r)
        if is_dtensor(margin):
            # DTensor has no rule for log-sigmoid's backward: the loss of
            # the whole batch on every rank
            loss = _whole(dpo_loss, margin)
        else:
            loss = dpo_loss(margin)
        metrics = {
            "loss": loss,
            "margin": torch.mean(margin),
            "reward_accuracy": torch.mean((margin > 0).float()),
            "logp_chosen": torch.mean(pol_c),
            "logp_rejected": torch.mean(pol_r),
        }
        return loss, metrics

    def dpo_step(state, batch, ref_params):
        metrics, grads = value_and_grad(loss_fn, state["params"], batch,
                                        ref_params, trainable=trainable)
        grads, metrics = laid_out(mesh_ctx, grads, state["params"], metrics)
        new_params, new_opt = optimizer.update(grads, state["opt"],
                                               state["params"])
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, metrics

    return dpo_step


def _whole(fn, t):
    """``fn(t)`` on the whole of the DTensor ``t``, replicated on every
    rank (so is its gradient)."""
    from torch.distributed.tensor import Replicate

    from ..models.base import local_call

    rep = [Replicate()] * t.device_mesh.ndim
    return local_call(fn, (t,), (rep,), (rep,), rep)


def _rows_call(fn, logits, labels, mask):
    """``fn(logits, labels, mask) -> [B]`` on each rank's rows of plain
    tensors: the batch dim cut as the logits' is, every other dim whole
    (the vocab gathered where it lay over ``model``).  A mesh dim that cuts
    no rows computes the same values on each of its ranks, so the logits'
    gradient is replicated there."""
    from torch.distributed.tensor import Replicate, Shard

    from ..models.base import local_call, replicate_like

    rows = [Shard(0) if isinstance(p, Shard) and p.dim % logits.ndim == 0
            else Replicate() for p in logits.placements]
    labels, mask = (replicate_like(t, logits) for t in (labels, mask))
    return local_call(fn, (logits, labels, mask), (rows, rows, rows),
                      (rows, rows, rows), rows)


@dataclasses.dataclass
class DPOGym(Gym):
    """The shared gym loop with the DPO step swapped in via the step hooks.

    ``ref_params`` must be assigned (a *copy*: the loop updates the state's
    tensors in place, and the reference must not follow them) after
    setup/warmstart and before the first step.  Under a mesh the copy is
    laid out as the params (JAX's ``_extra_step_shardings``): a DTensor
    copy of each leaf holds a copy of its rank's block."""

    beta: float = 0.1
    ref_params: Any = None

    def _build_step(self, mesh_ctx, storage_axes):
        if self.grad_accum > 1:
            raise NotImplementedError(
                "DPO does not support grad_accum > 1 yet; raise the batch")
        return make_dpo_step(self.model, self.optimizer, mesh_ctx,
                             storage_axes, beta=self.beta)

    def _step_extra_args(self):
        if self.ref_params is None:
            raise RuntimeError("DPOGym.ref_params is unset: assign the "
                               "frozen reference before stepping")
        return (self.ref_params,)
