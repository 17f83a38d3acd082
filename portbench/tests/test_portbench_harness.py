"""The harness is driven by data: a cell, a traffic file, a configuration
and a metric reader dropped into a copy are found by name with no edit.
A traffic file's ``kind`` picks the module that runs it.  A run with no
card, or in a directory holding only the benchmark, fails and prints no
result."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, tiny_cell
from portbench import harness


def _copy(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    return root


def test_new_cell_and_metric_are_found_by_name(tmp_path):
    root = _copy(tmp_path)
    tiny = tiny_cell()
    pb = root / "portbench"
    (pb / "configs" / "tiny-ssm.json").write_text(json.dumps(tiny["config"]))
    (pb / "traffic" / "tokens.tiny.json").write_text(
        json.dumps(tiny["traffic"]))
    (pb / "limits" / "tiny-ssm.train.4x64.json").write_text(
        json.dumps({"limits": tiny["limits"]}))
    (pb / "metrics" / "window_steps.train.py").write_text(
        '"""Steps in the window."""\n\n\n'
        'def read(run):\n    return run["window"]["steps"]\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-ssm", "source": "tests",
                             "file": "portbench/configs/tiny-ssm.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "tiny-ssm.train.4x64",
                               "config": "tiny-ssm",
                               "traffic": "tokens.tiny", "chips": 1,
                               "why": "tests"})
    bench["per_layer"].append({"name": "window_steps.train", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "gym and input",
                               "moves": "train_tokens_per_s",
                               "workloads": ["tiny-ssm.train.4x64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell(str(root), "tiny-ssm.train.4x64")
    assert cell["traffic"]["seq_len"] == 64
    assert cell["limits"] == tiny["limits"]
    assert [m["name"] for m in cell["per_layer"]] == ["window_steps.train"]
    record = harness.run_cell(cell, 5, 0.2, True, device="cpu")
    out = harness.result_line(record, True, root=str(root))
    assert out["metrics"]["window_steps.train"]["value"] == \
        record["window"]["steps"] >= 2
    assert out["correct"], out["checks"]


def _run_cli(cwd):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "mamba2-780m.train.24x2048", "--seed", "3000000001", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_fails_without_a_result():
    p = _run_cli(ROOT)
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "no CUDA device" in p.stderr


def test_benchmark_alone_fails_without_a_result(tmp_path):
    root = _copy(tmp_path)
    p = _run_cli(root)
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "repro_torch is missing" in p.stderr


def test_kind_and_architecture_are_found_by_name():
    from portbench import reference
    from portbench.kinds import train
    from portbench.reference import ssm

    assert harness.load_kind("train") is train
    assert reference.model({"arch_type": "ssm"}) is ssm
    with pytest.raises(ModuleNotFoundError):
        harness.load_kind("serve_nothing")
    with pytest.raises(ValueError, match="no reference"):
        reference.model({"arch_type": "no_such_arch"})
