"""Tokenizers (pluggable components; port of ``repro.data.tokenizer``).

ByteTokenizer — reversible byte-level tokenizer (256 bytes + specials).
BpeTokenizer — byte-pair-encoding trained on a corpus sample; pure python,
built for the pipeline benchmark and tests, not for linguistic quality.
Both give JAX's ids, merges and saved files; no torch here (the pipeline's
spawned workers import this module).
"""
from __future__ import annotations

import collections
import json
from typing import Dict, Iterable, List, Optional, Tuple


class ByteTokenizer:
    PAD, BOS, EOS = 0, 1, 2
    _OFFSET = 3

    @property
    def vocab_size(self) -> int:
        return 256 + self._OFFSET

    def encode(self, text: str, bos: bool = False, eos: bool = False) -> List[int]:
        ids = [b + self._OFFSET for b in text.encode("utf-8")]
        if bos:
            ids = [self.BOS] + ids
        if eos:
            ids = ids + [self.EOS]
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        bs = bytes(i - self._OFFSET for i in ids if i >= self._OFFSET)
        return bs.decode("utf-8", errors="replace")


class BpeTokenizer:
    """Byte-level BPE: specials(3) + bytes(256) + merges."""

    PAD, BOS, EOS = 0, 1, 2
    _OFFSET = 3

    def __init__(self, merges: Optional[List[Tuple[int, int]]] = None):
        self.merges: List[Tuple[int, int]] = merges or []
        self._rebuild()

    def _rebuild(self):
        self.merge_rank: Dict[Tuple[int, int], int] = {
            tuple(m): i for i, m in enumerate(self.merges)
        }
        self.merge_id: Dict[Tuple[int, int], int] = {
            tuple(m): 256 + self._OFFSET + i for i, m in enumerate(self.merges)
        }

    @property
    def vocab_size(self) -> int:
        return 256 + self._OFFSET + len(self.merges)

    @classmethod
    def train(cls, texts: Iterable[str], n_merges: int = 256) -> "BpeTokenizer":
        tok = cls()
        seqs = [[b + cls._OFFSET for b in t.encode("utf-8")] for t in texts]
        for _ in range(n_merges):
            counts = collections.Counter()
            for s in seqs:
                counts.update(zip(s, s[1:]))
            if not counts:
                break
            pair, freq = counts.most_common(1)[0]
            if freq < 2:
                break
            tok.merges.append(pair)
            tok._rebuild()
            nid = tok.merge_id[pair]
            seqs = [tok._apply_one(s, pair, nid) for s in seqs]
        return tok

    @staticmethod
    def _apply_one(seq: List[int], pair: Tuple[int, int], nid: int) -> List[int]:
        out = []
        i = 0
        while i < len(seq):
            if i + 1 < len(seq) and (seq[i], seq[i + 1]) == pair:
                out.append(nid)
                i += 2
            else:
                out.append(seq[i])
                i += 1
        return out

    def encode(self, text: str, bos: bool = False, eos: bool = False) -> List[int]:
        seq = [b + self._OFFSET for b in text.encode("utf-8")]
        while len(seq) >= 2:
            best, best_rank = None, None
            for p in zip(seq, seq[1:]):
                r = self.merge_rank.get(p)
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = p, r
            if best is None:
                break
            seq = self._apply_one(seq, best, self.merge_id[best])
        if bos:
            seq = [self.BOS] + seq
        if eos:
            seq = seq + [self.EOS]
        return seq

    def decode(self, ids: Iterable[int]) -> str:
        def expand(i: int) -> bytes:
            if i < self._OFFSET:
                return b""
            if i < 256 + self._OFFSET:
                return bytes([i - self._OFFSET])
            a, b = self.merges[i - 256 - self._OFFSET]
            return expand(a) + expand(b)

        return b"".join(expand(i) for i in ids).decode("utf-8", errors="replace")

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"merges": self.merges}, f)

    @classmethod
    def load(cls, path: str) -> "BpeTokenizer":
        with open(path) as f:
            data = json.load(f)
        return cls([tuple(m) for m in data["merges"]])
