"""``correct`` at a tiny size on the CPU: a sound run passes; the control
(the reference with its products in fp8, in the program's place) and each
fault planted under the timed path fail.  The harness's look for a card is
skipped (``device="cpu"``); the rest of a run is driven as on the card."""
import os
import tempfile

import pytest

from conftest import tiny_cell
from portbench import correct, faults, harness, traffic
from portbench.kinds import train
from portbench.reference.lm import fp8_mm

SEEDS = (1, 2)


def _run(seed, hook=None):
    cell = tiny_cell()
    record = harness.run_cell(cell, seed, 0.2, False, device="cpu", hook=hook)
    return cell, record, harness.result_line(record, False)


@pytest.mark.parametrize("seed", SEEDS)
def test_sound_run_is_correct(seed):
    _, record, out = _run(seed)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    # the CPU has no device memory to read: peak_mem_gib stays out
    assert set(out["metrics"]) == {"train_tokens_per_s", "setup_s"}


@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(seed):
    cell, record, _ = _run(seed)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t")
        traffic.write(cell["traffic"], train.token_ids(cell["config"]), seed,
                      path, path + ".idx")
        batches = train.check_batches(path, cell["traffic"], "cpu")
    ctl = train.reference_readings(cell, seed, batches, "cpu", mm=fp8_mm)
    checks, ok = correct.compare(ctl, record["reference"], cell["limits"])
    assert not ok, checks


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_not_correct(fault):
    _, _, out = _run(SEEDS[0], hook=faults.FAULTS[fault])
    assert not out["correct"], out["checks"]


def test_limits_decide_what_is_compared():
    cell, record, _ = _run(SEEDS[0])
    checks, ok = correct.compare(record["readings"], record["reference"], None)
    assert not ok and checks == {}
    some = {k: v for k, v in cell["limits"].items() if k != "loss_gap"}
    checks, ok = correct.compare(record["readings"], record["reference"], some)
    assert ok and set(checks) == {"grad_gap", "change_gap"}


@pytest.mark.gpu
def test_mamba2_cell_is_correct_on_the_card(cuda):
    root = harness.root_dir()
    cell = harness.load_cell(root, "mamba2-780m.train.24x2048")
    record = harness.run_cell(cell, 2**31 + 17, 5.0, True, device="cuda")
    out = harness.result_line(record, True)
    assert out["correct"], out["checks"]
    assert "ssd_scan_roofline.train" in out["metrics"]
    assert 0 < out["device"]["busy_s"] < out["device"]["window_s"]
