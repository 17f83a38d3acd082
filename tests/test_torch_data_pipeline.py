"""The port's data pipeline (``repro_torch.data``: the JSONL indexer, the
byte and BPE tokenizers, the producer-consumer tokenizer pipeline, and the
``tokenizer/*`` and ``dataset/sft_jsonl`` components) against the JAX
package's, on the CPU.

The pipeline is host code in both packages, integers and bytes from end to
end, so every comparison is exact (``==``, or byte-equal files): the index
arrays and their ``.idx.npy`` caches, the BPE merges, every encoding and
decoding, the saved tokenizer files, the ``.tokens.u32`` / ``.docidx.npy``
files of the parallel pipeline (2 spawned workers) and of the serial
baseline, and the SFT rows.  Each package indexes its own copy of the
corpus: ``index_jsonl`` writes its cache next to the file.
"""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core.components  # noqa: F401  (JAX's catalog)
from repro.config.registry import DEFAULT_REGISTRY as JREG
from repro.data import indexer as JIX
from repro.data import tokenize_pipeline as JTP
from repro.data import tokenizer as JTK
from repro.data.packed_dataset import PackedDataset as JaxPackedDataset

from repro_torch.config.registry import DEFAULT_REGISTRY as REG
from repro_torch.core.components import register_all
from repro_torch.data import indexer as IX
from repro_torch.data import tokenize_pipeline as TP
from repro_torch.data import tokenizer as TK
from repro_torch.data.packed_dataset import PackedDataset

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORDS = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog",
         "lorem", "ipsum", "dolor", "sit", "amet", "naïve", "café", "日本"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Nothing here computes with torch, but the registry's model factories
    are imported with it: one thread for this module, restored after it,
    as in every port test file since PR 17."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(n_docs=240, seed=0):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, int(rng.integers(3, 50))))
            for _ in range(n_docs)]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """One numpy-seeded JSONL corpus, copied once per package (each
    package's ``index_jsonl`` caches next to its own copy)."""
    d = tmp_path_factory.mktemp("corpus")
    docs = _corpus()
    with open(d / "port.jsonl", "w") as f:
        for i, doc in enumerate(docs):
            # a blank line and a last line without a newline: both indexers
            # skip the one and keep the other
            f.write(("\n" if i == 7 else "") + json.dumps({"text": doc}))
            if i < len(docs) - 1:
                f.write("\n")
    shutil.copy(d / "port.jsonl", d / "jax.jsonl")
    return str(d / "port.jsonl"), str(d / "jax.jsonl"), docs


@pytest.fixture(scope="module")
def bpe_pair(corpus):
    _, _, docs = corpus
    return (TK.BpeTokenizer.train(docs[:60], n_merges=64),
            JTK.BpeTokenizer.train(docs[:60], n_merges=64))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_data_modules_import_no_torch():
    """The pipeline's spawned workers import these modules: none may pull
    in torch (or anything that does), nor the JAX package."""
    code = ("import sys; import repro_torch.data.tokenize_pipeline, "
            "repro_torch.data.tokenizer, repro_torch.data.indexer, "
            "repro_torch.sweep; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'repro')); print(bad); assert not bad")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_index_and_cache_byte_equal_to_jax(corpus):
    port_path, jax_path, docs = corpus
    ours, theirs = IX.index_jsonl(port_path), JIX.index_jsonl(jax_path)
    assert ours.dtype == theirs.dtype == np.int64
    assert np.array_equal(ours, theirs) and len(ours) == len(docs)
    assert _read(port_path + IX.INDEX_SUFFIX) == \
        _read(jax_path + JIX.INDEX_SUFFIX)
    # the cache is reused while it is newer than the file
    assert np.array_equal(IX.index_jsonl(port_path), ours)
    for i in (0, 7, 8, len(docs) - 1):
        assert IX.read_document(port_path, ours, i) == docs[i] == \
            JIX.read_document(jax_path, theirs, i)


def test_index_small_chunks_equal_jax(tmp_path):
    """Lines straddling read chunks (``chunk_bytes`` 7): JAX's offsets."""
    docs = _corpus(30, seed=5)
    for name in ("p.jsonl", "j.jsonl"):
        with open(tmp_path / name, "w") as f:
            f.write("".join(json.dumps({"text": d}) + "\n" for d in docs))
    assert np.array_equal(
        IX.index_jsonl(str(tmp_path / "p.jsonl"), chunk_bytes=7),
        JIX.index_jsonl(str(tmp_path / "j.jsonl"), chunk_bytes=7))


def test_bpe_merges_equal_jax(bpe_pair):
    ours, theirs = bpe_pair
    assert ours.merges == theirs.merges and len(ours.merges) == 64
    assert ours.vocab_size == theirs.vocab_size


def test_bpe_training_stops_where_jax_stops():
    """No pair occurs twice: both stop before ``n_merges``."""
    texts = ["abcdefg", "hij"]
    assert TK.BpeTokenizer.train(texts, 50).merges == \
        JTK.BpeTokenizer.train(texts, 50).merges


@given(st.text(max_size=200))
@settings(max_examples=60, deadline=None)
def test_byte_tokenizer_equals_jax(text):
    ours, theirs = TK.ByteTokenizer(), JTK.ByteTokenizer()
    for bos, eos in ((False, False), (True, True)):
        ids = ours.encode(text, bos=bos, eos=eos)
        assert ids == theirs.encode(text, bos=bos, eos=eos)
        assert ours.decode(ids) == theirs.decode(ids) == text
    assert ours.vocab_size == theirs.vocab_size


@given(st.text(alphabet=st.characters(min_codepoint=32, max_codepoint=300),
               max_size=120))
@settings(max_examples=40, deadline=None)
def test_bpe_encode_decode_equal_jax(bpe_pair, text):
    ours, theirs = bpe_pair
    ids = ours.encode(text, bos=True, eos=True)
    assert ids == theirs.encode(text, bos=True, eos=True)
    assert ours.decode(ids) == theirs.decode(ids) == text


@given(st.lists(st.integers(0, 64 + 258), max_size=40))
@settings(max_examples=30, deadline=None)
def test_bpe_decode_of_any_ids_equals_jax(bpe_pair, ids):
    ours, theirs = bpe_pair
    assert ours.decode(ids) == theirs.decode(ids)


def test_bpe_save_load_byte_equal(bpe_pair, tmp_path):
    ours, theirs = bpe_pair
    ours.save(str(tmp_path / "port.json"))
    theirs.save(str(tmp_path / "jax.json"))
    assert _read(tmp_path / "port.json") == _read(tmp_path / "jax.json")
    # each package loads the other's file
    assert TK.BpeTokenizer.load(str(tmp_path / "jax.json")).merges == \
        JTK.BpeTokenizer.load(str(tmp_path / "port.json")).merges == \
        ours.merges


@pytest.mark.parametrize("kind", ["byte", "bpe"])
def test_pipeline_files_byte_equal_to_jax(corpus, bpe_pair, tmp_path, kind):
    """The port's parallel pipeline (2 spawned workers, a batch size that
    leaves a ragged last batch) and its serial baseline write JAX's
    serial files, byte for byte, and each package's ``PackedDataset``
    reads the same documents."""
    port_path, jax_path, docs = corpus
    ours, theirs = ((TK.ByteTokenizer(), JTK.ByteTokenizer())
                    if kind == "byte" else bpe_pair)
    par = TP.tokenize_file(port_path, str(tmp_path / "par"), ours,
                           n_workers=2, batch_docs=17)
    ser = TP.tokenize_file_serial(port_path, str(tmp_path / "ser"), ours)
    ref = JTP.tokenize_file_serial(jax_path, str(tmp_path / "jax"), theirs)
    for got in (par, ser):
        assert (got["n_docs"], got["n_tokens"]) == \
            (ref["n_docs"], ref["n_tokens"])
        assert _read(got["tokens_path"]) == _read(ref["tokens_path"])
        assert _read(got["docidx_path"]) == _read(ref["docidx_path"])
    ds, jds = PackedDataset(str(tmp_path / "par")), \
        JaxPackedDataset(str(tmp_path / "jax"))
    assert ds.n_docs == jds.n_docs == len(docs)
    for i in (0, 42, len(docs) - 1):
        got = ds.document(i).tolist()
        assert got == jds.document(i).tolist()
        assert ours.decode(got[:-1]) == docs[i] and got[-1] == ours.EOS


def test_pipeline_of_jax_matches_port_parallel(corpus, tmp_path):
    """JAX's own parallel pipeline against the port's, 3 workers each."""
    port_path, jax_path, _ = corpus
    a = TP.tokenize_file(port_path, str(tmp_path / "p"), TK.ByteTokenizer(),
                         n_workers=3, batch_docs=64)
    b = JTP.tokenize_file(jax_path, str(tmp_path / "j"), JTK.ByteTokenizer(),
                          n_workers=3, batch_docs=64)
    assert _read(a["tokens_path"]) == _read(b["tokens_path"])
    assert _read(a["docidx_path"]) == _read(b["docidx_path"])


def test_pipeline_fails_fast_when_a_worker_dies(corpus, tmp_path):
    """A worker that raises (here: a missing field) fails the pipeline at
    once, not after the 60 s stall guard, and leaves no process behind."""
    import multiprocessing as mp
    import time

    port_path, _, _ = corpus
    before = set(mp.active_children())
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="a worker exited with code 1"):
        TP.tokenize_file(port_path, str(tmp_path / "x"), TK.ByteTokenizer(),
                         n_workers=2, field="missing")
    assert time.perf_counter() - t0 < 30
    assert not [p for p in set(mp.active_children()) - before
                if p.is_alive()]


def test_pipeline_of_an_empty_corpus(tmp_path):
    (tmp_path / "empty.jsonl").write_text("")
    a = TP.tokenize_file(str(tmp_path / "empty.jsonl"), str(tmp_path / "e"),
                         TK.ByteTokenizer(), n_workers=2)
    assert (a["n_docs"], a["n_tokens"]) == (0, 0)
    assert np.load(a["docidx_path"]).tolist() == [0]


def _sft_file(path, n=24, seed=3):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(n):
            f.write(json.dumps({
                "prompt": " ".join(rng.choice(WORDS, int(rng.integers(2, 8)))),
                "response": " ".join(rng.choice(WORDS,
                                                int(rng.integers(2, 10))))})
                    + "\n")


@pytest.mark.parametrize("tokenizer", ["byte", "bpe"])
def test_sft_jsonl_rows_equal_jax(tmp_path, tokenizer):
    """``dataset/sft_jsonl`` through the registries, over each package's
    own ``tokenizer/*`` component: rows, masks and order ``==``."""
    register_all()
    _sft_file(tmp_path / "sft.jsonl")
    (tmp_path / "corpus.txt").write_text("\n".join(_corpus(40, seed=9)))
    tk = {"corpus": str(tmp_path / "corpus.txt"), "n_merges": 32} \
        if tokenizer == "bpe" else {}
    kw = dict(path=str(tmp_path / "sft.jsonl"), seq_len=32, seed=1, eos_id=2)
    ours = REG.build("dataset", "sft_jsonl", tokenizer=REG.build(
        "tokenizer", tokenizer, **tk), **kw)
    theirs = JREG.build("dataset", "sft_jsonl", tokenizer=JREG.build(
        "tokenizer", tokenizer, **tk), **kw)
    assert np.array_equal(ours.rows, theirs.rows)
    assert np.array_equal(ours.row_mask, theirs.row_mask)
    assert np.array_equal(ours.order, theirs.order)


def test_sft_jsonl_missing_field_message_equals_jax(tmp_path):
    register_all()
    (tmp_path / "bad.jsonl").write_text('{"prompt": "a"}\n')
    errors = []
    for reg in (REG, JREG):
        with pytest.raises(ValueError) as e:
            reg.build("dataset", "sft_jsonl", path=str(tmp_path / "bad.jsonl"),
                      seq_len=8, tokenizer=reg.build("tokenizer", "byte"))
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "missing field 'response'" in errors[0]


# JAX's tests/test_run_api.py::test_bpe_factory_*, through the port's registry
def test_bpe_factory_trains_with_n_merges(tmp_path):
    register_all()
    corpus = tmp_path / "corpus.txt"
    corpus.write_text("aaabbb aaabbb aaabbb\n" * 50)
    tok = REG.build("tokenizer", "bpe", corpus=str(corpus), n_merges=4)
    assert 0 < len(tok.merges) <= 4
    tok8 = REG.build("tokenizer", "bpe", corpus=str(corpus), n_merges=8)
    assert len(tok8.merges) >= len(tok.merges)
    assert tok8.merges == JREG.build("tokenizer", "bpe", corpus=str(corpus),
                                     n_merges=8).merges


def test_bpe_factory_flags_n_merges_without_corpus(tmp_path):
    register_all()
    errors = []
    for reg in (REG, JREG):
        with pytest.raises(ValueError, match="n_merges") as e:
            reg.build("tokenizer", "bpe", n_merges=16)
        errors.append(str(e.value))
    saved = tmp_path / "tok.json"
    REG.build("tokenizer", "bpe").save(str(saved))
    for reg in (REG, JREG):
        with pytest.raises(ValueError, match="n_merges") as e:
            reg.build("tokenizer", "bpe", path=str(saved), n_merges=16)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and errors[2] == errors[3]
    assert REG.build("tokenizer", "bpe", path=str(saved)).merges == []


def test_tokenizer_components_materialize_as_jax(tmp_path):
    """A graph naming the tokenizers and ``dataset/sft_jsonl`` fills the
    same defaults, so it has one fingerprint in both packages."""
    from repro.run.fingerprint import fingerprint as jax_fp
    from repro.run.fingerprint import materialize as jax_materialize
    from repro_torch.run.fingerprint import fingerprint, materialize

    register_all()
    doc = {"run": {"kind": "sft"},
           "tok": {"component_key": "tokenizer", "variant_key": "bpe",
                   "config": {"path": "x.json"}},
           "byte": {"component_key": "tokenizer", "variant_key": "byte"},
           "dataset": {"component_key": "dataset", "variant_key": "sft_jsonl",
                       "config": {"path": "sft.jsonl", "seq_len": 16,
                                  "tokenizer": {"instance_key": "byte"}}}}
    assert materialize(doc) == jax_materialize(doc)
    assert fingerprint(materialize(doc)) == jax_fp(jax_materialize(doc))
