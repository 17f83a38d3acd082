"""The port's run artifacts, ``replay`` and ``validate`` against the JAX
package's, on the CPU.

``resolved.yaml`` (the materialized document, ``yaml.safe_dump`` in JAX's
key order) and ``manifest.json`` (``{name, kind, fingerprint}``) must be
byte-equal to what JAX's ``write_artifacts`` writes for the same document,
so each package replays the other's run directories.
"""
import json
import os

import pytest
import torch
import yaml

import repro.core.components as jax_components
import repro.run.kinds  # noqa: F401  (JAX's run kinds: the warmstart schema)
from repro.config.resolver import load_yaml as jax_load_yaml
from repro.run import api as jax_api
from repro.run.config import parse_run_doc as jax_parse_run_doc
from repro.run.fingerprint import materialize as jax_materialize
from repro.run.fingerprint import write_artifacts as jax_write_artifacts
from repro_torch.config.resolver import load_yaml
from repro_torch.core.components import register_all
from repro_torch.run import api
from repro_torch.run.cli import main as cli_main
from repro_torch.run.config import RunError, parse_run_doc
from repro_torch.run.fingerprint import (MANIFEST_FILE, RESOLVED_FILE,
                                         materialize, read_manifest,
                                         write_artifacts)
from repro_torch.run.overrides import apply_overrides, parse_overrides

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = os.path.join(ROOT, "examples", "configs")
PORTED = ["quickstart", "serve", "serve_engine", "warmstart", "sft", "dpo",
          "bench", "lr_sweep", "ablation_dryrun", "dryrun", "trace",
          "train_pp"]
NOT_PORTED = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are reduced: their ops are far too small to split
    across threads, and under the suite's parallel workers, which share the
    host's cores, torch's default of one thread per core leaves each op
    waiting on descheduled threads.  One thread for this module, restored
    after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(_msg):
    pass


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", PORTED)
def test_artifacts_are_byte_equal_to_jax(name, tmp_path):
    path = os.path.join(CONFIGS, f"{name}.yaml")
    register_all()
    cfg = parse_run_doc(load_yaml(path), default_name=name)
    write_artifacts(str(tmp_path / "port"), materialize(cfg.doc), cfg.name,
                    cfg.kind)
    jax_components.register_all()
    jcfg = jax_parse_run_doc(jax_load_yaml(path), default_name=name)
    jax_write_artifacts(str(tmp_path / "jax"), jax_materialize(jcfg.doc),
                        jcfg.name, jcfg.kind)
    for fn in (RESOLVED_FILE, MANIFEST_FILE):
        assert _read(tmp_path / "port" / fn) == _read(tmp_path / "jax" / fn)


def _tiny_train_doc(tmp_path, steps=2, log_every=1):
    doc = load_yaml(os.path.join(CONFIGS, "quickstart.yaml"))
    return apply_overrides(doc, parse_overrides([
        "run.name=tiny", f"run.output_dir={tmp_path / 'run'}",
        f"run.train.steps={steps}", "arch.config.n_layers=1",
        "variables.seq_len=32", "loader.config.global_batch=4",
        "dataset.config.n_tokens=40000",
        f"dataset.config.prefix={tmp_path / 'data'}",
        "gym.config.prefetch=0", f"gym.config.log_every={log_every}"]))


def test_train_run_writes_artifacts_and_replays(tmp_path):
    result = api.execute_doc(_tiny_train_doc(tmp_path), device="cpu",
                             write_result=True, log=_quiet)
    assert result["final_loss"] > 0 and result["logged_points"] == 2
    run_dir = tmp_path / "run"
    assert result["output_dir"] == str(run_dir)
    manifest = read_manifest(str(run_dir))
    assert manifest == {"name": "tiny", "kind": "train",
                        "fingerprint": result["fingerprint"]}
    with open(run_dir / "result.json") as f:
        on_disk = json.load(f)
    assert on_disk["final_loss"] == result["final_loss"]
    assert on_disk["fingerprint"] == result["fingerprint"]

    replayed = api.replay(str(run_dir), device="cpu", log=_quiet)
    assert replayed["fingerprint"] == result["fingerprint"]
    assert [h["loss"] for h in replayed["history"]] == \
        [h["loss"] for h in result["history"]]


def test_replay_rejects_edited_artifact(tmp_path):
    api.execute_doc(_tiny_train_doc(tmp_path, steps=1), device="cpu",
                    write_result=True, log=_quiet)
    run_dir = tmp_path / "run"
    doc = yaml.safe_load((run_dir / RESOLVED_FILE).read_text())
    doc["optimizer"]["config"]["lr"] = 0.9
    (run_dir / RESOLVED_FILE).write_text(yaml.safe_dump(doc))
    with pytest.raises(RunError, match="fingerprint mismatch"):
        api.replay(str(run_dir), device="cpu", log=_quiet)
    with pytest.raises(RunError, match="no resolved config"):
        api.replay(str(tmp_path), device="cpu", log=_quiet)


def test_cli_train_and_replay(tmp_path, capsys):
    cfg_path = tmp_path / "run.yaml"
    cfg_path.write_text(yaml.safe_dump(_tiny_train_doc(tmp_path)))
    rc = cli_main(["train", "--config", str(cfg_path), "--device", "cpu",
                   "--set", "run.train.steps=1"])
    out = capsys.readouterr().out
    assert rc == 0 and "run artifact:" in out
    rc = cli_main(["replay", str(tmp_path / "run"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "replayed train run: fingerprint sha256:" in out


def test_jax_run_directory_replays_in_the_port(tmp_path):
    """JAX executes the tiny document (writing its artifacts); the port
    replays JAX's run directory with the same fingerprint."""
    jres = jax_api.execute_doc(_tiny_train_doc(tmp_path, steps=1))
    run_dir = str(tmp_path / "run")
    assert read_manifest(run_dir)["fingerprint"] == jres["fingerprint"]
    res = api.replay(run_dir, device="cpu", log=_quiet)
    assert res["fingerprint"] == jres["fingerprint"]
    assert read_manifest(run_dir)["fingerprint"] == jres["fingerprint"]
    assert res["steps"] == 1 and res["logged_points"] == 1


def test_validate_examples(capsys):
    rc = cli_main(["validate", CONFIGS])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0, lines
    status = {os.path.splitext(os.path.basename(line.split()[1]))[0]:
              line for line in lines}
    assert set(status) == set(PORTED) | set(NOT_PORTED)
    assert len(status) == 12
    for name in PORTED:
        assert status[name].startswith("ok "), status[name]
    for name, item in NOT_PORTED.items():
        assert status[name].startswith("skip ") and status[name].endswith(
            f"(not ported: ROADMAP {item})"), status[name]


def test_validate_catches_bad_component(tmp_path, capsys):
    bad = tmp_path / "bad.yaml"
    bad.write_text("run: {kind: train}\n"
                   "gym: {component_key: gym, variant_key: warp_drive}\n")
    rc = cli_main(["validate", str(bad)])
    out = capsys.readouterr().out
    assert rc == 1 and out.startswith("FAIL ") and "unknown variant" in out
