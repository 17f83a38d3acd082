"""The one generator of the benchmark's training traffic: seeded token
rows of the step's shape.

A traffic file (``traffic/<name>.json``) names the ``kind`` of run that
serves it (the module ``kinds/<kind>.py``), the step's shape (global batch,
sequence length), how often the loop fetches its metrics (``log_every``),
the set-up steps and the rows to write.  Tokens are drawn uniformly over
the ids the configuration's tokenizer emits and written as the packed
stream the program reads (uint32 tokens and an int64 document index that
holds the stream as one document: the loader cuts fixed rows and reads no
boundary).  Row ``k`` is the stream's ``k``-th chunk of ``seq_len + 1``
tokens: inputs its first ``seq_len``, labels its last.  The same seed
writes the same bytes; every seed gives every step the same shape.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np


def load(root: str, name: str) -> Dict[str, Any]:
    path = os.path.join(root, "portbench", "traffic", f"{name}.json")
    with open(path) as f:
        return json.load(f)


def stream(traffic: Dict[str, Any], n_ids: int, seed: int) -> np.ndarray:
    """The uint32 tokens of ``traffic``'s rows, ids in ``[0, n_ids)``."""
    n_tokens = int(traffic["rows"]) * (int(traffic["seq_len"]) + 1)
    rng = np.random.default_rng(int(seed))
    return rng.integers(0, n_ids, size=n_tokens, dtype=np.uint32)


def write(traffic, n_ids: int, seed: int, tokens_path: str,
          docidx_path: str) -> None:
    tokens = stream(traffic, n_ids, seed)
    tokens.tofile(tokens_path)
    with open(docidx_path, "wb") as f:
        np.save(f, np.asarray([0, len(tokens)], dtype=np.int64))


def rows(tokens_path: str, seq_len: int, first: int, count: int):
    """Rows ``first .. first + count - 1`` of the packed stream as
    (inputs, labels), int64 arrays ``[count, seq_len]``."""
    w = seq_len + 1
    data = np.fromfile(tokens_path, dtype=np.uint32,
                       count=(first + count) * w)
    chunk = data[first * w:].reshape(count, w).astype(np.int64)
    return chunk[:, :-1], chunk[:, 1:]
