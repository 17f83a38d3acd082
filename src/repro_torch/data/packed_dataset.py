"""Memory-mapped packed token datasets (port of ``repro.data.packed_dataset``,
paper §Data Pipeline, stage 3): O(1) random access to tokenized documents,
fixed-length chunking for training, and global shuffling.

Host-side numpy, as in JAX: batches are numpy dicts, placed on the device by
the gym or by ``data.prefetch.PrefetchLoader``.  The same seed writes the
same files and yields the same batches as the JAX package."""
from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Tuple

import numpy as np

from .tokenize_pipeline import DOCIDX_SUFFIX, TOKENS_SUFFIX


class PackedDataset:
    """Token stream + document index, both memory-mapped."""

    def __init__(self, prefix: str):
        self.tokens = np.memmap(prefix + TOKENS_SUFFIX, dtype=np.uint32, mode="r")
        self.docidx = np.load(prefix + DOCIDX_SUFFIX, mmap_mode="r")

    @property
    def n_docs(self) -> int:
        return len(self.docidx) - 1

    @property
    def n_tokens(self) -> int:
        return int(self.docidx[-1])

    def document(self, i: int) -> np.ndarray:
        """O(1) random access to tokenized document i."""
        lo, hi = int(self.docidx[i]), int(self.docidx[i + 1])
        return np.asarray(self.tokens[lo:hi])


@dataclasses.dataclass
class ChunkedLMDataset:
    """Fixed seq_len chunks over the packed stream, globally shuffled."""

    dataset: PackedDataset
    seq_len: int
    seed: int = 0
    shuffle: bool = True

    def __post_init__(self):
        self.n_samples = self.dataset.n_tokens // (self.seq_len + 1)
        self.order = np.arange(self.n_samples)
        if self.shuffle:
            np.random.default_rng(self.seed).shuffle(self.order)

    def __len__(self) -> int:
        return self.n_samples

    def sample(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        x, y = self.sample_batch(np.asarray([i]))
        return x[0], y[0]

    def sample_batch(self, idxs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized assembly: one strided gather for the whole batch
        ([B, seq_len+1] fancy-index on the memmap) instead of B Python
        slices — the loader hot path."""
        ks = self.order[np.asarray(idxs, dtype=np.int64) % max(self.n_samples, 1)]
        w = self.seq_len + 1
        offs = ks[:, None] * w + np.arange(w, dtype=np.int64)[None, :]
        chunks = self.dataset.tokens[offs].astype(np.int32)
        return np.ascontiguousarray(chunks[:, :-1]), np.ascontiguousarray(chunks[:, 1:])


def _vectorized_dataset(ds) -> bool:
    """Does this dataset's ``sample_batch`` get the fast gather path?

    The contract, in priority order:

    1. An explicit ``vectorized`` attribute (class- or instance-level
       bool) decides outright — the opt-in for datasets that define
       ``sample_batch`` somewhere awkward in their MRO (wrappers,
       mixins), and the opt-out for datasets whose ``sample_batch``
       exists but must not be used batched.
    2. Otherwise ``sample_batch`` is used when it is defined *at least as
       derived* as ``sample`` in the MRO.  A subclass that overrides
       either method directly (``PackedSFTDataset`` overriding both, or a
       ``ChunkedLMDataset`` subclass overriding only ``sample_batch``)
       passes; a subclass that overrides only ``sample`` (the DatasetIF
       method) does NOT — its override would be silently bypassed by the
       inherited vectorized path.

    ``sample_batch(idxs)`` may return either the legacy ``(tokens,
    labels)`` 2-tuple or a dict batch (e.g. ``{"tokens", "labels",
    "loss_mask"}``); :class:`ShardedLoader` forwards dict batches as-is.
    Indices wrap modulo the dataset length (the loader streams raw
    increasing indices)."""
    explicit = getattr(ds, "vectorized", None)
    if explicit is not None:
        return bool(explicit)
    mro = type(ds).__mro__
    sb = next((i for i, c in enumerate(mro) if "sample_batch" in c.__dict__),
              None)
    if sb is None:
        return False
    s = next((i for i, c in enumerate(mro) if "sample" in c.__dict__), None)
    return s is None or sb <= s


@dataclasses.dataclass
class ShardedLoader:
    """Deterministic data-parallel loader: rank r of n reads samples
    i*n + r (the Modalities DP-sharded sampler analog)."""

    dataset: ChunkedLMDataset
    global_batch: int
    dp_rank: int = 0
    dp_size: int = 1

    def __post_init__(self):
        assert self.global_batch % self.dp_size == 0
        self.local_batch = self.global_batch // self.dp_size

    def batches(self, steps: int, start_step: int = 0) -> Iterator[dict]:
        """Yield dict batches.  A dataset whose ``sample_batch``/``sample``
        returns a dict (the loss-mask contract — see
        :func:`_vectorized_dataset`) is forwarded key-for-key; the legacy
        ``(tokens, labels)`` tuple becomes ``{"tokens", "labels"}``."""
        vectorized = _vectorized_dataset(self.dataset)
        for step in range(start_step, start_step + steps):
            lo = step * self.global_batch + self.dp_rank * self.local_batch
            if vectorized:
                out = self.dataset.sample_batch(
                    np.arange(lo, lo + self.local_batch, dtype=np.int64)
                )
                if isinstance(out, dict):
                    yield out
                    continue
                toks, labs = out
            else:  # custom DatasetIF components only define sample()
                samples = [self.dataset.sample(lo + j)
                           for j in range(self.local_batch)]
                if isinstance(samples[0], dict):
                    yield {k: np.stack([s[k] for s in samples])
                           for k in samples[0]}
                    continue
                toks = np.stack([s[0] for s in samples])
                labs = np.stack([s[1] for s in samples])
            yield {"tokens": toks, "labels": labs}


def synthetic_dataset(n_tokens: int, vocab: int, prefix: str, seed: int = 0,
                      avg_doc_len: int = 512):
    """Write a synthetic packed dataset (tests / examples without a corpus).

    Each file is written under a name of this process's and moved into
    place, the doc index last: ranks that write the same dataset at once
    never read a partial file, and a reader that finds the doc index finds
    the tokens."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, vocab, size=n_tokens, dtype=np.uint32)
    bounds = [0]
    pos = 0
    while pos < n_tokens:
        pos = min(n_tokens, pos + int(rng.integers(avg_doc_len // 2, avg_doc_len * 2)))
        bounds.append(pos)

    def put(suffix, write):
        tmp = f"{prefix}{suffix}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            write(f)
        os.replace(tmp, prefix + suffix)

    put(TOKENS_SUFFIX, toks.tofile)
    put(DOCIDX_SUFFIX, lambda f: np.save(f, np.asarray(bounds, np.int64)))
    return PackedDataset(prefix)
