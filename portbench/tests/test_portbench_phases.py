"""The train step's device phases as the readers see them: the mean of a
step's summed spans inside the window, the traced chunk's kernels against
the phase spans, and a traced run on the CPU, where the program writes no
``device/*`` span and the four readers report nothing."""
import pytest

from conftest import ROOT, tiny_cell
from portbench import harness, phases


def _run(spans, t0=10.0, t1=20.0, events=()):
    return {"window": {"t0": t0, "t1": t1}, "spans": spans,
            "profile": {"t0": t0, "t1": t1, "device_events": list(events)}}


def test_ms_per_step_sums_a_step_and_averages_the_window():
    spans = [("device/ssd_backward", 11.0, 11.25, 1),
             ("device/ssd_backward", 11.5, 11.75, 1),
             ("device/ssd_backward", 15.0, 15.5, 2),
             ("device/ssd_backward", 9.0, 9.5, 0),      # before the window
             ("step/ssd_backward", 11.0, 12.0, 1)]      # the host's
    assert phases.ms_per_step(_run(spans), "device/ssd_backward") == \
        pytest.approx(500.0)
    assert phases.ms_per_step(_run(spans), "device/forward") is None


def test_chunk_check_finds_a_kernel_outside_the_phases():
    spans = [("device/forward", 10.0, 11.0, 1),
             ("device/backward", 11.0, 14.0, 1),
             ("device/ssd_backward", 12.0, 12.5, 1),
             ("device/optimizer", 14.0, 14.5, 1)]
    events = [("fwd_k", 10.1, 10.9), ("ssd_k", 12.1, 12.4),
              ("Memcpy HtoD", 9.0, 9.1), ("late_k", 14.5, 14.502),
              ("opt_k", 14.1, 14.4)]
    c = phases.chunk_check(_run(spans, 9.0, 15.0, events))
    assert c["steps"] == 1 and c["kernels"] == 4
    assert c["worst_kernel"] == "late_k"
    assert c["worst_outside_s"] == pytest.approx(0.002)
    assert c["covered_share"] == pytest.approx(4.5 / 6.0)
    ssd = c["by_phase"]["device/ssd_backward"]
    assert ssd["kernels"] == {"ssd_k": [pytest.approx(0.3), 1]}
    assert ssd["s"] == pytest.approx(0.5)
    assert ssd["busy_s"] == pytest.approx(0.3)
    bwd = c["by_phase"]["device/backward"]
    assert bwd["kernels"] == {} and bwd["busy_s"] == pytest.approx(0.3)
    # late_k starts where the optimizer's span ends: no part of it inside
    assert c["by_phase"]["device/optimizer"]["busy_s"] == pytest.approx(0.3)


def test_traced_run_on_the_cpu_reports_no_device_phase():
    cell = tiny_cell()
    record = harness.run_cell(cell, 3, 0.2, True, device="cpu",
                              reference=False)
    names = {s[0] for s in record["spans"]}
    assert {"step/forward", "step/backward", "step/optimizer",
            "step/ssd_backward", "gym/run_enter", "gym/run_exit"} <= names
    assert not [n for n in names if n.startswith("device/")]
    for m in ("fwd_device_ms.train", "bwd_device_ms.train",
              "opt_device_ms.train", "ssd_bwd_device_ms.train"):
        assert harness.load_reader(ROOT, m)(record) is None
