"""Supervised fine-tuning datasets (port of ``repro.posttrain.sft``, numpy
only, so the rows are JAX's bit for bit): prompt/response pairs with
prompt-loss masking, packed into fixed-length training rows.

An SFT example is ``(prompt_tokens, response_tokens)``.  The dataset
assembles the standard next-token rows (``tokens``/``labels`` shifted by
one) plus a ``loss_mask`` aligned with ``labels`` that is 1 exactly where
the *predicted* token belongs to a response (including the optional EOS
terminator) — the loss already threads the mask
(:func:`repro_torch.train.steps.compute_loss` → masked mean), so SFT reuses the
pretraining step byte-for-byte.

Two layouts:

- ``pack: true`` (default) — examples are concatenated into one token
  stream and chunked every ``seq_len + 1`` tokens, exactly like
  :class:`~repro_torch.data.packed_dataset.ChunkedLMDataset`: no pad waste,
  examples may span row boundaries (their mask travels with them).
- ``pack: false`` — one example per row, right-padded with ``pad_id``
  (mask 0 on the padding), truncated when longer than ``seq_len + 1``.

``sample_batch`` returns a *dict* batch — the vectorized-loader contract
(see ``data/packed_dataset.py::_vectorized_dataset``) so the mask rides
the fast gather path through :class:`ShardedLoader`/``PrefetchLoader``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

Example = Tuple[np.ndarray, np.ndarray]      # (prompt tokens, response tokens)


def _as_i32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.int32).reshape(-1)


@dataclasses.dataclass
class PackedSFTDataset:
    """Prompt/response pairs -> fixed-length rows with a response mask."""

    examples: Sequence[Example]
    seq_len: int
    seed: int = 0
    shuffle: bool = True
    pack: bool = True
    pad_id: int = 0
    eos_id: int = -1              # >= 0: append EOS to every response (masked IN)

    #: dict-returning ``sample_batch`` is the whole point (loss_mask batches)
    vectorized = True

    def __post_init__(self):
        if not self.examples:
            raise ValueError("PackedSFTDataset needs at least one example")
        w = self.seq_len + 1
        toks: List[np.ndarray] = []
        mask: List[np.ndarray] = []
        for prompt, response in self.examples:
            p, r = _as_i32(prompt), _as_i32(response)
            if self.eos_id >= 0:
                r = np.concatenate([r, np.asarray([self.eos_id], np.int32)])
            t = np.concatenate([p, r])
            m = np.concatenate([np.zeros(len(p), np.int32),
                                np.ones(len(r), np.int32)])
            if not self.pack:
                t, m = t[:w], m[:w]
                pad = w - len(t)
                if pad:
                    t = np.concatenate([t, np.full(pad, self.pad_id, np.int32)])
                    m = np.concatenate([m, np.zeros(pad, np.int32)])
            toks.append(t)
            mask.append(m)
        if self.pack:
            stream_t = np.concatenate(toks)
            stream_m = np.concatenate(mask)
            n = len(stream_t) // w
            if n == 0:
                raise ValueError(
                    f"packed SFT stream has {len(stream_t)} tokens — shorter "
                    f"than one row (seq_len+1 = {w}); add examples or shrink "
                    f"seq_len")
            self.rows = stream_t[: n * w].reshape(n, w)
            self.row_mask = stream_m[: n * w].reshape(n, w)
        else:
            self.rows = np.stack(toks)
            self.row_mask = np.stack(mask)
        self.n_samples = len(self.rows)
        self.order = np.arange(self.n_samples)
        if self.shuffle:
            np.random.default_rng(self.seed).shuffle(self.order)

    def __len__(self) -> int:
        return self.n_samples

    def sample(self, i: int) -> Dict[str, np.ndarray]:
        b = self.sample_batch(np.asarray([i]))
        return {k: v[0] for k, v in b.items()}

    def sample_batch(self, idxs: np.ndarray) -> Dict[str, np.ndarray]:
        """One gather for the whole batch; the mask is shifted with the
        labels, so ``loss_mask[t]`` gates the prediction of ``labels[t]``."""
        ks = self.order[np.asarray(idxs, np.int64) % max(self.n_samples, 1)]
        rows = self.rows[ks]
        mask = self.row_mask[ks]
        return {
            "tokens": np.ascontiguousarray(rows[:, :-1]),
            "labels": np.ascontiguousarray(rows[:, 1:]),
            "loss_mask": np.ascontiguousarray(mask[:, 1:]).astype(np.float32),
        }


# ---------------------------------------------------------------------------
# example sources
# ---------------------------------------------------------------------------
def synthetic_sft_examples(n_examples: int, vocab: int, seed: int = 0,
                           prompt_len: Tuple[int, int] = (4, 12),
                           response_len: Tuple[int, int] = (4, 12)
                           ) -> List[Example]:
    """Seeded instruction-like pairs with *learnable* responses: random
    prompts, responses that count up from the prompt's last token — a tiny
    model's masked loss visibly drops within ~20 steps (the CI smoke
    asserts exactly that), while the prompt tokens stay random noise."""
    rng = np.random.default_rng(seed)
    lo = min(3, vocab - 1)
    out: List[Example] = []
    for _ in range(n_examples):
        p_len = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        r_len = int(rng.integers(response_len[0], response_len[1] + 1))
        prompt = rng.integers(lo, vocab, size=p_len).astype(np.int32)
        start = int(prompt[-1])
        response = ((start + 1 + np.arange(r_len)) % (vocab - lo) + lo
                    ).astype(np.int32)
        out.append((prompt, response))
    return out


def load_sft_jsonl(path: str, tokenizer: Any,
                   prompt_field: str = "prompt",
                   response_field: str = "response") -> List[Example]:
    """Chat-template-free JSONL: one object per line, two text fields,
    tokenized with any :class:`TokenizerIF` — no schema beyond the two
    field names (configurable for datasets that call them
    instruction/output)."""
    out: List[Example] = []
    with open(path) as f:
        for ln, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            obj = json.loads(line)
            for field in (prompt_field, response_field):
                if field not in obj:
                    raise ValueError(
                        f"{path}:{ln + 1}: missing field {field!r} "
                        f"(have {sorted(obj)})")
            out.append((_as_i32(tokenizer.encode(obj[prompt_field])),
                        _as_i32(tokenizer.encode(obj[response_field]))))
    if not out:
        raise ValueError(f"{path}: no examples")
    return out


# -- registry factories -----------------------------------------------------
def sft_synthetic_dataset(seq_len: int, vocab: int, n_examples: int = 256,
                          seed: int = 0, shuffle: bool = True,
                          pack: bool = True, eos_id: int = -1,
                          prompt_len: Optional[Sequence[int]] = None,
                          response_len: Optional[Sequence[int]] = None
                          ) -> PackedSFTDataset:
    examples = synthetic_sft_examples(
        n_examples, vocab, seed=seed,
        prompt_len=tuple(prompt_len or (4, 12)),
        response_len=tuple(response_len or (4, 12)))
    return PackedSFTDataset(examples, seq_len=seq_len, seed=seed,
                            shuffle=shuffle, pack=pack, eos_id=eos_id)


def sft_jsonl_dataset(path: str, seq_len: int, tokenizer: Any,
                      prompt_field: str = "prompt",
                      response_field: str = "response", seed: int = 0,
                      shuffle: bool = True, pack: bool = True,
                      pad_id: int = 0, eos_id: int = -1) -> PackedSFTDataset:
    examples = load_sft_jsonl(path, tokenizer, prompt_field=prompt_field,
                              response_field=response_field)
    return PackedSFTDataset(examples, seq_len=seq_len, seed=seed,
                            shuffle=shuffle, pack=pack, pad_id=pad_id,
                            eos_id=eos_id)
