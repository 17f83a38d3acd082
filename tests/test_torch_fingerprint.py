"""The port's run fingerprint against the JAX package's (ROADMAP C2).

JAX fingerprints a run by hashing its materialized document: the run
section with every setting filled, ``${var}`` interpolated, and each
component node's config filled with its factory's defaults
(``repro.run.fingerprint``).  The port keeps its own copy of that module
over its own registry, so one document must give one fingerprint in both
packages: equality, not a prefix.
"""
import json
import os

import pytest

from repro.config.resolver import load_yaml
from repro.core.components import register_all as jax_register_all
from repro.run.config import parse_run_doc as jax_parse_run_doc
from repro.run.fingerprint import fingerprint as jax_fingerprint
from repro.run.fingerprint import materialize as jax_materialize
from repro_torch.core.components import register_all
from repro_torch.run import api
from repro_torch.run.config import parse_run_doc
from repro_torch.run.fingerprint import materialize
from repro_torch.run.overrides import apply_overrides, parse_overrides

ROOT = os.path.join(os.path.dirname(__file__), "..")
DOCS = ["quickstart", "serve", "serve_engine"]


def _doc(name, *sets):
    doc = load_yaml(os.path.join(ROOT, "examples", "configs", f"{name}.yaml"))
    return apply_overrides(doc, parse_overrides(list(sets)))


def _jax_fp(doc):
    jax_register_all()
    return jax_fingerprint(jax_materialize(jax_parse_run_doc(doc).doc))


@pytest.mark.parametrize("name", DOCS)
def test_fingerprint_equals_jax(name):
    doc = _doc(name)
    assert api.fingerprint(parse_run_doc(doc).doc) == _jax_fp(doc)


@pytest.mark.parametrize("name", DOCS)
def test_materialized_document_equals_jax_and_is_a_fixpoint(name):
    """The materialized form is JAX's, key for key, and materializing it
    again changes nothing (the replay contract)."""
    register_all()
    jax_register_all()
    doc = _doc(name)
    mine = materialize(parse_run_doc(doc).doc)
    assert mine == jax_materialize(jax_parse_run_doc(doc).doc)
    assert materialize(parse_run_doc(mine).doc) == mine


def test_fingerprint_follows_overrides_as_jax_does():
    """The hybrid's training document and a smaller engine trace: still the
    same fingerprint in both packages, and a different one from the
    unchanged document."""
    for name, sets in (
            ("quickstart", ["arch.variant_key=zamba2_2p7b",
                            "arch.config.use_flash_kernel=true"]),
            ("serve_engine", ["run.serve.workload.n_requests=3",
                              "run.serve.bench_dir=elsewhere"])):
        doc = _doc(name, *sets)
        fp = api.fingerprint(parse_run_doc(doc).doc)
        assert fp == _jax_fp(doc)
        assert fp != _jax_fp(_doc(name))


def test_bench_file_carries_jax_fingerprint(tmp_path, monkeypatch):
    """The engine document (smaller trace, no static baseline) writes
    ``BENCH_serve_quickstart.json`` into its output directory, JAX's
    ``"."`` default being read as that directory, with JAX's fingerprint of
    the same document."""
    monkeypatch.chdir(tmp_path)
    doc = _doc("serve_engine", "run.serve.workload.n_requests=2",
               "run.serve.workload.realtime=false",
               "run.serve.compare_static=false",
               f"run.output_dir={tmp_path / 'run'}")
    res = api.execute_doc(doc, device="cpu", write_result=True,
                          log=lambda m: None)
    bench = tmp_path / "run" / "BENCH_serve_quickstart.json"
    assert res["bench_file"] == str(bench)
    assert json.loads(bench.read_text())["fingerprint"] == _jax_fp(doc)
    assert not (tmp_path / "BENCH_serve_quickstart.json").exists()
