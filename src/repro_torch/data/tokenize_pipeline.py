"""Producer–consumer tokenization (port of ``repro.data.tokenize_pipeline``,
paper §Data Pipeline, stage 2).

Single reader (contiguous I/O) -> batch queue -> N tokenizer workers ->
single writer that restores document order and streams a packed uint32
memmap + int64 document index: O(1) random access to tokenized documents.
The files are byte-equal to the JAX package's for the same corpus and
tokenizer, and ``data.packed_dataset.PackedDataset`` reads them.

Host code with no torch, as in JAX: the workers are ``spawn`` processes
(``fork`` would copy a parent's live CUDA context), each of which imports
this module and the tokenizer's, so neither may import torch.
``tokenize_file_serial`` is the one-process baseline the pipeline is
checked and timed against.
"""
from __future__ import annotations

import heapq
import json
import multiprocessing as mp
import queue
import threading
from typing import Any, Dict, List

import numpy as np

from .indexer import index_jsonl

TOKENS_SUFFIX = ".tokens.u32"
DOCIDX_SUFFIX = ".docidx.npy"


def _worker(tok, in_q: mp.Queue, out_q: mp.Queue, field: str):
    while True:
        item = in_q.get()
        if item is None:
            out_q.put(None)
            return
        seq_id, lines = item
        toks: List[List[int]] = []
        for raw in lines:
            text = json.loads(raw)[field]
            toks.append(tok.encode(text, eos=True))
        out_q.put((seq_id, toks))


def _next_result(out_q, workers, stall_s: float = 60.0, poll_s: float = 1.0):
    """The next worker result; a worker that died (a nonzero exit code)
    fails the pipeline at once, and 60 s without a result is a stall."""
    waited = 0.0
    while True:
        try:
            return out_q.get(timeout=poll_s)
        except queue.Empty:
            dead = [w.exitcode for w in workers if w.exitcode not in (None, 0)]
            if dead:
                raise RuntimeError(f"tokenizer pipeline: a worker exited "
                                   f"with code {dead[0]}") from None
            waited += poll_s
            if waited >= stall_s:
                raise RuntimeError("tokenizer pipeline stalled") from None


def tokenize_file(
    path: str,
    out_prefix: str,
    tokenizer,
    n_workers: int = 2,
    batch_docs: int = 64,
    field: str = "text",
    queue_size: int = 16,
) -> Dict[str, Any]:
    """Tokenize one JSONL file into <out_prefix>.tokens.u32 + .docidx.npy."""
    index = index_jsonl(path)
    n_docs = len(index)
    ctx = mp.get_context("spawn")  # fork would copy a CUDA context
    in_q: mp.Queue = ctx.Queue(maxsize=queue_size)
    out_q: mp.Queue = ctx.Queue(maxsize=queue_size)
    workers = [
        ctx.Process(target=_worker, args=(tokenizer, in_q, out_q, field), daemon=True)
        for _ in range(n_workers)
    ]
    for w in workers:
        w.start()

    tokens_path = out_prefix + TOKENS_SUFFIX
    doc_offsets = [0]
    total_tokens = 0
    n_batches = (n_docs + batch_docs - 1) // batch_docs

    def producer():
        with open(path, "rb") as f:
            sent = 0
            for b in range(n_batches):
                lo = b * batch_docs
                hi = min(n_docs, lo + batch_docs)
                start = int(index[lo, 0])
                end = int(index[hi - 1, 0] + index[hi - 1, 1])
                f.seek(start)
                blob = f.read(end - start)
                lines = []
                for i in range(lo, hi):
                    o = int(index[i, 0]) - start
                    lines.append(blob[o : o + int(index[i, 1])])
                in_q.put((b, lines))
                sent += 1
        for _ in workers:
            in_q.put(None)

    prod = threading.Thread(target=producer, daemon=True)
    prod.start()

    # writer: restore order with a heap, stream to disk
    next_id = 0
    pending: List = []
    done_workers = 0
    try:
        with open(tokens_path, "wb") as out_f:
            while done_workers < len(workers) or pending or next_id < n_batches:
                item = _next_result(out_q, workers)
                if item is None:
                    done_workers += 1
                    if done_workers == len(workers) and next_id >= n_batches:
                        break
                    continue
                heapq.heappush(pending, item)
                while pending and pending[0][0] == next_id:
                    _, toks = heapq.heappop(pending)
                    for t in toks:
                        arr = np.asarray(t, dtype=np.uint32)
                        arr.tofile(out_f)
                        total_tokens += len(t)
                        doc_offsets.append(total_tokens)
                    next_id += 1
                if next_id >= n_batches and not pending:
                    break
        prod.join()
        for w in workers:
            w.join(timeout=10)
    except BaseException:
        for q in (in_q, out_q):
            # nobody reads what is left in them: do not block the exit
            q.cancel_join_thread()
        raise
    finally:
        # a stalled or failed pipeline leaves no worker behind
        for w in workers:
            if w.is_alive():
                w.terminate()
                w.join(timeout=10)
    docidx = np.asarray(doc_offsets, dtype=np.int64)
    np.save(out_prefix + DOCIDX_SUFFIX, docidx)
    return {
        "n_docs": n_docs,
        "n_tokens": total_tokens,
        "tokens_path": tokens_path,
        "docidx_path": out_prefix + DOCIDX_SUFFIX,
    }


def tokenize_file_serial(path: str, out_prefix: str, tokenizer,
                         field: str = "text") -> Dict[str, Any]:
    """Single-process baseline (the benchmark's comparison point)."""
    index = index_jsonl(path)
    doc_offsets = [0]
    total = 0
    with open(path, "rb") as f, open(out_prefix + TOKENS_SUFFIX, "wb") as out_f:
        for i in range(len(index)):
            f.seek(int(index[i, 0]))
            raw = f.read(int(index[i, 1]))
            t = tokenizer.encode(json.loads(raw)[field], eos=True)
            np.asarray(t, dtype=np.uint32).tofile(out_f)
            total += len(t)
            doc_offsets.append(total)
    np.save(out_prefix + DOCIDX_SUFFIX, np.asarray(doc_offsets, dtype=np.int64))
    return {"n_docs": len(index), "n_tokens": total,
            "tokens_path": out_prefix + TOKENS_SUFFIX,
            "docidx_path": out_prefix + DOCIDX_SUFFIX}
