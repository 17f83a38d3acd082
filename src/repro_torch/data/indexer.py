"""JSONL indexation: find document boundaries so downstream stages get O(1)
random access to raw documents (port of ``repro.data.indexer``, paper
§Data Pipeline, stage 1).  The ``.idx.npy`` cache is byte-equal to JAX's."""
from __future__ import annotations

import json
import os
from typing import List, Tuple

import numpy as np

INDEX_SUFFIX = ".idx.npy"


def index_jsonl(path: str, chunk_bytes: int = 1 << 20) -> np.ndarray:
    """Return int64 array of (offset, length) per line; cached next to file."""
    idx_path = path + INDEX_SUFFIX
    if os.path.exists(idx_path) and os.path.getmtime(idx_path) >= os.path.getmtime(path):
        return np.load(idx_path)
    offsets: List[Tuple[int, int]] = []
    pos = 0
    start = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                break
            cursor = 0
            while True:
                nl = chunk.find(b"\n", cursor)
                if nl < 0:
                    break
                end = pos + nl
                if end > start:
                    offsets.append((start, end - start))
                start = end + 1
                cursor = nl + 1
            pos += len(chunk)
    if pos > start:  # trailing line without newline
        offsets.append((start, pos - start))
    arr = np.asarray(offsets, dtype=np.int64).reshape(-1, 2)
    np.save(idx_path, arr)
    return arr


def read_document(path: str, index: np.ndarray, i: int, field: str = "text") -> str:
    off, length = int(index[i, 0]), int(index[i, 1])
    with open(path, "rb") as f:
        f.seek(off)
        raw = f.read(length)
    return json.loads(raw)[field]
