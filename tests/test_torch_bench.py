"""The port's ``bench`` run kind (``Gym.bench`` behind
``run.kinds.execute_bench``) against the JAX package's, on the CPU: JAX's
bench document of ``tests/test_perf_path.py`` (reduced Qwen, batch 4 x 32,
3 measured steps) through both packages' run APIs, the result's keys and
schema numbers, the bench file and its fingerprint, the final loss from
JAX's initial state, where ``bench_dir: "."`` writes, the CLI line, and the
card the kind runs on by default.

Tolerance: ``CURVE_TOL`` (2e-3 absolute on losses near 6.3), the quickstart
curve's (``tests/test_torch_gym.py``): the bench's final loss is the fifth
step's of the same model, data and optimizer, whose per-step losses differ
by bf16 rounding alone.  Times are the CPU's and are held to nothing but
their signs: a time says something only on the card.
"""
import copy
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch
import yaml

import repro.core.components  # noqa: F401  (populates JAX's registry)
import repro.run.kinds  # noqa: F401  (registers JAX's run kinds)
from repro.config.resolver import resolve_config as jax_resolve_config
from repro.run import api as jax_api
from repro.run.config import RunError as JaxRunError
from repro.run.config import parse_run_doc as jax_parse_run_doc
from repro_torch.bridge import params_from_jax
from repro_torch.config.resolver import resolve_config
from repro_torch.core.components import register_all
from repro_torch.device import NoDeviceError
from repro_torch.run import api
from repro_torch.run.cli import main as cli_main
from repro_torch.run.config import RunError, parse_run_doc

CURVE_TOL = 2e-3
ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Reduced models: one torch thread for this module, restored after
    it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(_msg):
    pass


def _bench_doc(tmp_path, settings, name="benchtest"):
    """JAX's ``_quickstart_doc`` (``tests/test_perf_path.py``) as a bench
    run."""
    return {
        "run": {"kind": "bench", "name": name,
                "output_dir": str(tmp_path / "run"), "bench": settings},
        "arch": {"component_key": "arch_config",
                 "variant_key": "qwen1p5_0p5b", "config": {"reduced": True}},
        "model": {"component_key": "model", "variant_key": "auto",
                  "config": {"arch_config": {"instance_key": "arch"}}},
        "optimizer": {"component_key": "optimizer", "variant_key": "adamw",
                      "config": {"lr": 0.001}},
        "dataset": {"component_key": "dataset", "variant_key": "synthetic",
                    "config": {"n_tokens": 30000, "vocab": 512,
                               "prefix": str(tmp_path / "pack"),
                               "seq_len": 32}},
        "loader": {"component_key": "loader", "variant_key": "sharded",
                   "config": {"dataset": {"instance_key": "dataset"},
                              "global_batch": 4}},
        "gym": {"component_key": "gym", "variant_key": "standard",
                "config": {"model": {"instance_key": "model"},
                           "optimizer": {"instance_key": "optimizer"},
                           "loader": {"instance_key": "loader"},
                           "log_every": 2}},
    }


def _read(path):
    with open(path) as f:
        return json.load(f)


def test_bench_kind_matches_jax(tmp_path):
    """One document, both packages' run APIs: the same result keys and
    bench-file keys, steps, warmup and windows, FLOPs, batch geometry,
    goodput and fingerprint; ``result.json`` carries the bench file's
    step time; the telemetry rows of each window and the summary."""
    settings = {"steps": 3, "warmup": 1, "bench_dir": str(tmp_path / "b")}
    path = str(tmp_path / "b" / "BENCH_benchtest.json")
    os.makedirs(tmp_path / "b")
    jres = jax_api.execute_doc(_bench_doc(tmp_path, settings))
    jbench = _read(path)
    res = api.execute_doc(_bench_doc(tmp_path, settings), device="cpu",
                          write_result=True, log=_quiet)
    bench = _read(path)
    assert res["bench_file"] == jres["bench_file"] == path
    assert set(res) == set(jres)
    assert set(bench) == set(jbench)
    for r in (res, jres):
        assert r["steps"] == 3 and r["warmup"] == 1
        assert [w["steps"] for w in r["windows"]] == [1, 1, 1]
        assert r["steps_dispatched"] == 3 and r["rollback_count"] == 0
        assert r["steady_step_ms"] > 0 and r["compile_s"] > 0
    for key in ("model_flops_per_step", "global_batch", "seq_len", "goodput",
                "prefetch", "grad_accum", "graceful_exit", "retry_count",
                "arch", "n_layers", "remat", "scan_block_size", "name"):
        assert res[key] == jres[key], key
    assert res["goodput"] == 1.0
    assert bench["fingerprint"] == jbench["fingerprint"] == res["fingerprint"]
    on_disk = _read(tmp_path / "run" / "result.json")
    assert on_disk["steady_step_ms"] == bench["steady_step_ms"] == \
        res["steady_step_ms"]
    assert res["tokens_per_s"] == int(4 * 32 / (res["steady_step_ms"] / 1e3))
    rows = [json.loads(line) for line in
            open(tmp_path / "run" / "telemetry.jsonl")]
    phases = [r.get("attrs", {}).get("phase") for r in rows
              if r["type"] == "metric" and r["run"] == "benchtest"
              and r.get("fingerprint") == res["fingerprint"]]
    assert phases.count("bench_window") == 3
    assert phases.count("bench_summary") == 1
    for key in ("rows", "metric_rows", "span_rows", "event_rows"):
        assert res["telemetry"][key] == jres["telemetry"][key], key


def test_bench_final_loss_from_jax_initial_state(tmp_path):
    """JAX's ``Gym.bench`` and the port's from JAX's initial state, on the
    same dataset files: the loss of the last measured step within
    ``CURVE_TOL``; the port draws exactly 1 + warmup + steps batches and
    stops its prefetch worker."""
    doc = _bench_doc(tmp_path, {})
    graph = {k: v for k, v in doc.items() if k != "run"}
    register_all()
    jgym = jax_resolve_config(copy.deepcopy(graph))["gym"]
    jstate = jgym.setup()
    params = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    jstate["params"]))
    jres = jgym.bench(steps=3, warmup=1, windows=5)
    gym = resolve_config(copy.deepcopy(graph))["gym"]
    gym.device = "cpu"

    def jax_init():
        return {"params": params, "opt": gym.optimizer.init(params),
                "step": torch.zeros((), dtype=torch.int32)}

    gym._init_state = jax_init
    drawn = []
    inner = gym.loader.batches

    def counting(steps, start_step=0):
        for batch in inner(steps, start_step=start_step):
            drawn.append(1)
            yield batch

    gym.loader.batches = counting
    res = gym.bench(steps=3, warmup=1, windows=5)
    assert abs(res["final_loss"] - jres["final_loss"]) <= CURVE_TOL, \
        (res["final_loss"], jres["final_loss"])
    assert len(drawn) == 1 + 1 + 3
    assert not [t for t in threading.enumerate()
                if t.name == "repro-torch-prefetch" and t.is_alive()]


def test_bench_dir_dot_is_the_output_dir(tmp_path, monkeypatch):
    """``bench_dir: "."`` (JAX's default) lands under the run's output_dir;
    nothing in the working directory changes."""
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    doc = _bench_doc(tmp_path, {"steps": 2, "warmup": 0, "windows": 2})
    assert parse_run_doc(doc).settings.bench_dir == "."
    res = api.execute_doc(doc, device="cpu", write_result=True, log=_quiet)
    assert res["bench_file"] == str(tmp_path / "run" / "BENCH_benchtest.json")
    assert os.path.exists(res["bench_file"])
    assert os.listdir(cwd) == []


def test_bench_windows_must_be_positive_as_in_jax(tmp_path):
    doc = _bench_doc(tmp_path, {"windows": 0})
    with pytest.raises(JaxRunError) as jerr:
        jax_parse_run_doc(doc)
    with pytest.raises(RunError) as err:
        parse_run_doc(doc)
    assert str(err.value) == str(jerr.value) == \
        "run.bench.windows must be >= 1, got 0"


def test_cli_bench_line(tmp_path, capsys):
    """``python -m repro_torch bench --device cpu`` prints JAX's bench line
    and the bench file's path."""
    path = tmp_path / "bench.yaml"
    path.write_text(yaml.safe_dump(_bench_doc(
        tmp_path, {"steps": 2, "warmup": 0, "windows": 2})))
    rc = cli_main(["bench", "--config", str(path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    line = next(x for x in out.splitlines() if x.startswith("bench 'benchtest'"))
    assert "compile " in line and "ms/step (median of 2 windows)" in line
    assert "tok/s" in line and ", mfu " in line
    bench_file = str(tmp_path / "run" / "BENCH_benchtest.json")
    assert f"bench artifact: {bench_file}" in out
    assert os.path.exists(bench_file)


def test_bench_document_validates_and_runs_unchanged(tmp_path, monkeypatch):
    """``examples/configs/bench.yaml`` parses as JAX parses it; its run
    (output_dir and dataset moved under tmp, 2 steps) never touches the
    tracked ``BENCH_quickstart.json`` at the repo root."""
    from repro.config.resolver import load_yaml as jax_load_yaml
    from repro.run.fingerprint import fingerprint as jax_fingerprint
    from repro.run.fingerprint import materialize as jax_materialize
    from repro_torch.config.resolver import load_yaml

    src = os.path.join(ROOT, "examples", "configs", "bench.yaml")
    tracked = os.path.join(ROOT, "BENCH_quickstart.json")
    with open(tracked, "rb") as f:
        before = f.read()
    cfg, jcfg = parse_run_doc(load_yaml(src)), jax_parse_run_doc(
        jax_load_yaml(src))
    assert cfg.doc["run"] == jcfg.doc["run"]
    assert api.fingerprint(cfg.doc) == jax_fingerprint(
        jax_materialize(jcfg.doc))
    monkeypatch.chdir(ROOT)
    res = api.execute_file(src, device="cpu", write_result=True, log=_quiet,
                           overrides=[f"run.output_dir={tmp_path / 'run'}",
                                      f"dataset.config.prefix={tmp_path / 'q'}",
                                      "run.bench.steps=2",
                                      "run.bench.warmup=0"])
    assert res["bench_file"] == str(tmp_path / "run" / "BENCH_quickstart.json")
    with open(tracked, "rb") as f:
        assert f.read() == before


def test_bench_without_a_card_needs_device_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the bench would run on it")
    with pytest.raises(NoDeviceError):
        api.execute_doc(_bench_doc(tmp_path, {"steps": 1}), log=_quiet)
