"""The port's resilience subsystem (``repro_torch.resilience``) and its
wiring against the JAX package's, on the CPU: the retry primitive, the
anomaly sentinel, fault injection, the preemption guard, the checkpoint
writer's error latch and retry, the ``resilience:`` settings, the gym's
rollback and preemption through the run API, and the engine's deadlines
and stall watchdog — each case of ``tests/test_resilience.py`` but its four
sweep cases (in ``tests/test_torch_sweep.py``) — plus parity: retry delays,
sentinel events and fault firings ``==`` JAX's on the same seeded inputs,
and one chaos document run by both packages from JAX's initial params.

The port's train step is deterministic on the CPU, so a chaos run of the
port must equal the port's clean run exactly (``==``, as JAX's own chaos
tests hold JAX).  Against JAX, losses agree within ``CURVE_TOL``
(``tests/test_torch_gym.py``: the two packages round bf16 activations at
other places); events and dispatched steps are ``==``.
"""
import json
import os
import re
import signal

import jax
import numpy as np
import pytest
import torch

import repro.core.components as jax_components
import repro.run.kinds  # noqa: F401  (JAX's run kinds)
from repro.resilience import FaultInjector as JaxFaultInjector
from repro.resilience import RetryPolicy as JaxRetryPolicy
from repro.resilience import StepSentinel as JaxStepSentinel
from repro.run import api as jax_api
from repro_torch.bridge import params_from_jax
from repro_torch.ckpt import (AsyncCheckpointer, RetentionPolicy,
                              list_checkpoints, read_manifest)
from repro_torch.ckpt.format import read_leaf
from repro_torch.config.resolver import load_yaml
from repro_torch.configs import get_reduced
from repro_torch.core.gym import Gym
from repro_torch.models import build_model
from repro_torch.resilience import (PREEMPTED_EXIT_CODE, AnomalyError,
                                    FaultInjector, FaultSpec,
                                    PreemptionGuard, RetryError, RetryPolicy,
                                    StepSentinel, call_with_retry,
                                    classify_failure)
from repro_torch.run import api
from repro_torch.run.cli import main as cli_main
from repro_torch.run.overrides import apply_overrides, parse_overrides
from repro_torch.serve.engine import EngineError, ServeEngine
from repro_torch.serve.workload import synthetic_trace

ROOT = os.path.join(os.path.dirname(__file__), "..")
QUICKSTART = os.path.join(ROOT, "examples", "configs", "quickstart.yaml")
SERVE_ENGINE = os.path.join(ROOT, "examples", "configs", "serve_engine.yaml")
CURVE_TOL = 2e-3    # tests/test_torch_gym.py
CHAOS = {"sentinel": True,
         "faults": [{"kind": "nan_loss", "at": 2},
                    {"kind": "nan_params", "at": 5},
                    {"kind": "preempt", "at": 7}]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Reduced models: their ops are far too small to split across threads,
    and under the suite's parallel workers one thread per core leaves each
    op waiting on descheduled threads.  One thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(_msg):
    pass


# ---------------------------------------------------------------------------
# retry: the one bounded-backoff primitive
# ---------------------------------------------------------------------------
def test_retry_policy_delays_are_deterministic_and_bounded():
    p = RetryPolicy(max_attempts=5, base_delay_s=0.05, max_delay_s=0.15,
                    jitter=0.25)
    delays = [p.delay_s(k) for k in (1, 2, 3, 4)]
    assert delays == [p.delay_s(k) for k in (1, 2, 3, 4)]
    for k, d in zip((1, 2, 3, 4), delays):
        base = min(0.05 * 2.0 ** (k - 1), 0.15)
        assert base <= d <= base * 1.25
    assert delays[3] <= 0.15 * 1.25


def test_retry_policy_validation():
    with pytest.raises(ValueError, match="max_attempts"):
        RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError, match=">= 0"):
        RetryPolicy(jitter=-1)


def test_retry_delays_equal_jax():
    """``delay_s(k)`` for k 0..31 ``==`` JAX's, over seeded policies (the
    jitter is a Knuth hash of k: bit for bit, no random state)."""
    rng = np.random.default_rng(0)
    for _ in range(8):
        kw = dict(max_attempts=int(rng.integers(1, 9)),
                  base_delay_s=float(rng.uniform(0, 0.5)),
                  max_delay_s=float(rng.uniform(0, 4)),
                  jitter=float(rng.uniform(0, 1)))
        ours, theirs = RetryPolicy(**kw), JaxRetryPolicy(**kw)
        assert [ours.delay_s(k) for k in range(32)] == \
            [theirs.delay_s(k) for k in range(32)]


def test_call_with_retry_absorbs_transient_then_succeeds():
    calls, slept, noted = [], [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("disk hiccup")
        return "ok"

    out = call_with_retry(flaky, policy=RetryPolicy(max_attempts=4),
                          on_retry=lambda a, e: noted.append((a, type(e))),
                          sleep=slept.append)
    assert out == "ok" and len(calls) == 3
    assert noted == [(1, OSError), (2, OSError)]
    assert slept == [RetryPolicy(max_attempts=4).delay_s(k) for k in (1, 2)]


def test_call_with_retry_exhaustion_raises_retry_error_from_last():
    def always():
        raise TimeoutError("never")

    with pytest.raises(RetryError) as ei:
        call_with_retry(always, policy=RetryPolicy(max_attempts=3),
                        sleep=lambda s: None)
    assert ei.value.attempts == 3
    assert isinstance(ei.value.__cause__, TimeoutError)


def test_call_with_retry_deterministic_failures_propagate_untouched():
    calls = []

    def bad():
        calls.append(1)
        raise ValueError("shape mismatch")

    with pytest.raises(ValueError, match="shape"):
        call_with_retry(bad, policy=RetryPolicy(max_attempts=5),
                        sleep=lambda s: None)
    assert len(calls) == 1


def test_classify_failure():
    assert classify_failure(OSError("io")) == "transient"
    assert classify_failure(TimeoutError) == "transient"
    assert classify_failure(ValueError("bad")) == "deterministic"
    assert classify_failure(AssertionError) == "deterministic"
    assert classify_failure(None) == "transient"


# ---------------------------------------------------------------------------
# sentinel: NaN / spike detection over flushed metric points
# ---------------------------------------------------------------------------
def test_sentinel_trips_on_non_finite():
    s = StepSentinel()
    assert s.check(1, {"loss": 2.0}) is None
    ev = s.check(2, {"loss": float("nan")})
    assert ev["reason"] == "non_finite" and ev["step"] == 2
    assert s.check(3, {"loss": float("inf")})["reason"] == "non_finite"
    assert s.check(4, {"other": float("nan")}) is None


def test_sentinel_spike_needs_history_then_trips():
    s = StepSentinel(spike_zscore=4.0, min_history=4)
    for i in range(1, 6):
        assert s.check(i, {"loss": 2.0 + 0.01 * i}) is None
    ev = s.check(6, {"loss": 50.0})
    assert ev and ev["reason"] == "spike" and ev["zscore"] > 4.0
    assert s.check(7, {"loss": 2.05}) is None


def test_sentinel_warmup_never_trips():
    s = StepSentinel(spike_zscore=1.0, min_history=8)
    for i in range(7):
        assert s.check(i, {"loss": float(10 ** i)}) is None


def test_sentinel_flat_window_does_not_divide_by_zero():
    s = StepSentinel(spike_zscore=3.0, min_history=2)
    for i in range(4):
        s.check(i, {"loss": 2.0})
    assert s.check(5, {"loss": 2.0 + 1e-9}) is None


def test_sentinel_reset_forgets_history():
    s = StepSentinel(spike_zscore=3.0, min_history=2)
    for i in range(4):
        s.check(i, {"loss": 2.0})
    s.reset()
    assert s.check(10, {"loss": 99.0}) is None


def test_sentinel_validation():
    with pytest.raises(ValueError, match="window"):
        StepSentinel(window=1)
    with pytest.raises(ValueError, match="min_history"):
        StepSentinel(min_history=1)
    with pytest.raises(ValueError, match="spike_zscore"):
        StepSentinel(spike_zscore=-1)


@pytest.mark.parametrize("zscore,window,min_history",
                         [(3.0, 32, 8), (2.0, 8, 2), (0.0, 32, 8)])
def test_sentinel_events_equal_jax(zscore, window, min_history):
    """A 200-point seeded loss curve with spikes, NaNs and Infs: the event
    dicts (and the clean points absorbed) ``==`` JAX's, key for key."""
    rng = np.random.default_rng(7)
    curve = 6.0 - np.linspace(0, 2, 200) + 0.05 * rng.standard_normal(200)
    curve[rng.choice(200, 12, replace=False)] += rng.uniform(0.5, 5, 12)
    curve[rng.choice(200, 5, replace=False)] = np.nan
    curve[rng.choice(200, 2, replace=False)] = np.inf
    kw = dict(spike_zscore=zscore, window=window, min_history=min_history)
    ours, theirs = StepSentinel(**kw), JaxStepSentinel(**kw)
    got = [ours.check(i, {"loss": float(v)}) for i, v in enumerate(curve)]
    want = [theirs.check(i, {"loss": float(v)}) for i, v in enumerate(curve)]
    # json spells NaN/Inf alike on both sides (nan != nan in a dict ==)
    assert json.dumps(got) == json.dumps(want)
    assert sum(e is not None for e in got) >= 7


# ---------------------------------------------------------------------------
# fault injection: deterministic scheduled failures
# ---------------------------------------------------------------------------
def test_fault_spec_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown fault kind"):
        FaultSpec("meteor_strike")
    with pytest.raises(ValueError, match="times"):
        FaultSpec("nan_loss", times=-1)


def test_injector_step_indexed_fires_once_by_default():
    inj = FaultInjector([{"kind": "nan_loss", "at": 5}])
    assert inj.pending("nan_loss") == 1
    assert inj.fire("nan_loss", index=4) is None
    assert inj.fire("nan_loss", index=5) is not None
    assert inj.pending("nan_loss") == 0
    assert inj.fire("nan_loss", index=5) is None
    assert [e["fault"] for e in inj.events] == ["nan_loss"]
    assert inj.events[0]["index"] == 5


def test_injector_times_fires_consecutively():
    inj = FaultInjector([FaultSpec("ckpt_io", at=1, times=2)])
    assert inj.fire("ckpt_io") is None
    assert inj.fire("ckpt_io") is not None
    assert inj.fire("ckpt_io") is not None
    assert inj.fire("ckpt_io") is None
    assert len(inj.events) == 2


def test_injector_from_config_and_pending():
    inj = FaultInjector.from_config([{"kind": "preempt", "at": 3},
                                     {"kind": "serve_stall", "seconds": 0.1}])
    assert inj.pending() == 2 and inj.pending("preempt") == 1
    assert FaultInjector.from_config(None).pending() == 0
    assert FaultInjector.from_config({"kind": "nan_loss"}).pending() == 1


def test_injector_firings_equal_jax():
    """A seeded schedule of every kind, queried at seeded indices (and
    call-indexed kinds by their counters): the firing records, the specs
    returned and ``pending`` after each query ``==`` JAX's."""
    rng = np.random.default_rng(3)
    kinds = ["nan_loss", "nan_params", "ckpt_io", "preempt", "serve_stall"]
    rows = [{"kind": kinds[int(rng.integers(5))],
             "at": int(rng.integers(-1, 12)), "times": int(rng.integers(0, 4)),
             "seconds": float(rng.uniform(0, 1))} for _ in range(12)]
    ours, theirs = FaultInjector.from_config(rows), \
        JaxFaultInjector.from_config(rows)
    for _ in range(300):
        kind = kinds[int(rng.integers(5))]
        index = None if kind in ("ckpt_io", "serve_stall") \
            else int(rng.integers(0, 15))
        a, b = ours.fire(kind, index), theirs.fire(kind, index)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.kind, a.at, a.times, a.seconds, a._fired) == \
                (b.kind, b.at, b.times, b.seconds, b._fired)
        assert ours.pending(kind) == theirs.pending(kind)
    assert ours.events == theirs.events and len(ours.events) > 10


def test_corrupt_params_nans_float_leaves_only():
    w = torch.ones((2, 2), dtype=torch.float32)
    state = {"params": {"w": w, "ids": torch.arange(3)},
             "step": torch.tensor(7, dtype=torch.int32)}
    out = FaultInjector.corrupt_params(state)
    assert torch.isnan(out["params"]["w"]).all()
    assert out["params"]["w"] is w            # in place, on its own device
    assert torch.equal(out["params"]["ids"], torch.arange(3))
    assert int(out["step"]) == 7


# ---------------------------------------------------------------------------
# preemption guard
# ---------------------------------------------------------------------------
def test_guard_request_latch_and_event():
    g = PreemptionGuard()
    assert not g.requested
    g.request(signal.SIGTERM)
    assert g.requested and g.received == signal.SIGTERM
    assert g.event(12) == {"kind": "preempt", "step": 12,
                           "signal": signal.SIGTERM, "resumable": True}
    g.clear()
    assert not g.requested and g.received is None


def test_guard_catches_real_sigterm_and_uninstall_restores():
    prev = signal.getsignal(signal.SIGTERM)
    g = PreemptionGuard()
    with g:
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.requested and g.received == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) == prev
    assert PREEMPTED_EXIT_CODE == 75


def test_guard_off_the_main_thread_is_a_flag_holder():
    """Handlers install on the main thread only: a guard installed in a
    worker thread (a prefetch worker, a pytest-xdist helper) leaves the
    process's handlers alone and still takes requests."""
    import threading

    prev = signal.getsignal(signal.SIGTERM)
    g = PreemptionGuard()
    t = threading.Thread(target=g.install)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert signal.getsignal(signal.SIGTERM) == prev
    g.request()
    assert g.requested
    g.uninstall()
    assert signal.getsignal(signal.SIGTERM) == prev


# ---------------------------------------------------------------------------
# checkpoint writer: error latch reusability + retry absorption
# ---------------------------------------------------------------------------
def test_checkpointer_usable_after_reraised_failure(tmp_path):
    d = str(tmp_path / "ck")
    ck = AsyncCheckpointer(d, RetentionPolicy(keep_last=4),
                           fault_injector=FaultInjector(
                               [{"kind": "ckpt_io", "at": 0}]))
    tree = {"w": torch.arange(4, dtype=torch.float32)}
    ck.save(tree, 1)
    with pytest.raises(OSError, match="injected ckpt_io"):
        ck.wait()
    ck.save(tree, 2)
    ck.wait()
    assert [s for s, _ in list_checkpoints(d)] == [2]
    ck.close()


def test_checkpointer_retry_absorbs_transient_io(tmp_path):
    d = str(tmp_path / "ck")
    ck = AsyncCheckpointer(
        d, RetentionPolicy(keep_last=4),
        retry=RetryPolicy(max_attempts=3, base_delay_s=0.001),
        fault_injector=FaultInjector([{"kind": "ckpt_io", "at": 0,
                                       "times": 2}]))
    ck.save({"w": torch.zeros(2)}, 1)
    ck.wait()
    assert ck.retry_count == 2
    assert [s for s, _ in list_checkpoints(d)] == [1]
    ck.close()


def test_checkpointer_retry_exhaustion_still_latches(tmp_path):
    ck = AsyncCheckpointer(
        str(tmp_path / "ck"), retry=RetryPolicy(max_attempts=2,
                                                base_delay_s=0.001),
        fault_injector=FaultInjector([{"kind": "ckpt_io", "at": 0,
                                       "times": 0}]))
    ck.save({"w": torch.zeros(2)}, 1)
    with pytest.raises(RetryError):
        ck.wait()
    ck.close()


def test_retried_write_finishes_before_the_buffer_is_refilled(tmp_path):
    """The host buffers are one allocation reused by every save: a write
    retried on the writer thread must commit the values of its own step,
    not the next save's (``save`` waits for it)."""
    d = str(tmp_path / "ck")
    ck = AsyncCheckpointer(
        d, RetentionPolicy(keep_last=4),
        retry=RetryPolicy(max_attempts=3, base_delay_s=0.05),
        fault_injector=FaultInjector([{"kind": "ckpt_io", "at": 0,
                                       "times": 2}]))
    w = torch.zeros(4)
    ck.save({"w": w}, 1)
    w.add_(1.0)
    ck.save({"w": w}, 2)
    ck.close()
    assert ck.retry_count == 2
    for step, want in ((1, 0.0), (2, 1.0)):
        path = f"{d}/step_{step:08d}"
        got = read_leaf(path, read_manifest(path)["leaves"]["w"])
        assert torch.equal(got, torch.full((4,), want))


# ---------------------------------------------------------------------------
# run config: the resilience block (JAX's messages)
# ---------------------------------------------------------------------------
def test_resilience_settings_coercion_and_validation():
    from repro_torch.run.config import RunError, TrainSettings

    s = TrainSettings(resilience={"sentinel": True, "max_rollbacks": 2,
                                  "ckpt_retry": {"max_attempts": 4},
                                  "faults": [{"kind": "nan_loss", "at": 3}]})
    assert s.resilience.sentinel.metric == "loss"
    assert s.resilience.max_rollbacks == 2
    assert s.resilience.ckpt_retry.max_attempts == 4
    assert s.resilience.faults[0]["kind"] == "nan_loss"
    with pytest.raises(RunError, match="unknown fault kind"):
        TrainSettings(resilience={"faults": [{"kind": "nope"}]})
    with pytest.raises(RunError, match="max_attempts"):
        TrainSettings(resilience={"ckpt_retry": {"max_attempts": 0}})
    with pytest.raises(RunError):
        TrainSettings(resilience={"sentinel": {"bogus_knob": 1}})


# ---------------------------------------------------------------------------
# end-to-end chaos through the run API
# ---------------------------------------------------------------------------
def _train_doc(tmp_path, name, steps, **train):
    """JAX's chaos document of ``tests/test_resilience.py``: reduced
    StableLM, one layer, log every step, a checkpoint every 2 steps."""
    return {
        "run": {"kind": "train", "name": name,
                "output_dir": str(tmp_path / name),
                "train": {"steps": steps, **train}},
        "arch": {"component_key": "arch_config",
                 "variant_key": "stablelm_1p6b",
                 "config": {"reduced": True, "n_layers": 1}},
        "model": {"component_key": "model", "variant_key": "auto",
                  "config": {"arch_config": {"instance_key": "arch"}}},
        "optimizer": {"component_key": "optimizer", "variant_key": "adamw",
                      "config": {"lr": 0.001}},
        "dataset": {"component_key": "dataset", "variant_key": "synthetic",
                    "config": {"n_tokens": 40000, "vocab": 512,
                               "prefix": str(tmp_path / "data"),
                               "seq_len": 32, "seed": 0}},
        "loader": {"component_key": "loader", "variant_key": "sharded",
                   "config": {"dataset": {"instance_key": "dataset"},
                              "global_batch": 4}},
        "gym": {"component_key": "gym", "variant_key": "standard",
                "config": {"model": {"instance_key": "model"},
                           "optimizer": {"instance_key": "optimizer"},
                           "loader": {"instance_key": "loader"},
                           "log_every": 1, "prefetch": 0,
                           "ckpt_every": 2}},
    }


def _run(doc, **kw):
    kw.setdefault("write_result", True)
    return api.execute_doc(doc, device="cpu", log=_quiet, **kw)


def _curve(*results):
    merged = {}
    for r in results:
        merged.update({m["step"]: m["loss"] for m in r["history"]})
    return merged


def _events(result):
    with open(result["events_file"]) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture(scope="module")
def clean8(tmp_path_factory):
    """The chaos document's clean 8-step run (the curve every recovery
    must reproduce)."""
    tmp = tmp_path_factory.mktemp("clean")
    return tmp, _run(_train_doc(tmp, "clean", 8), write_result=False)


def test_nan_rollback_curve_parity(clean8):
    tmp, clean = clean8
    assert clean["rollback_count"] == 0 and clean["retry_count"] == 0
    assert clean["graceful_exit"] is False
    chaos = _run(_train_doc(tmp, "chaos", 8, resilience={
        "sentinel": True, "faults": [{"kind": "nan_loss", "at": 5}]}))
    assert chaos["rollback_count"] == 1
    assert _curve(chaos) == _curve(clean)
    events = _events(chaos)
    assert [e["kind"] for e in events] == ["fault", "anomaly"]
    rb = next(e for e in events if e["kind"] == "anomaly")
    assert rb["reason"] == "non_finite" and rb["step"] == 5
    assert rb["restored_step"] < 5 and rb["rollbacks"] == 1


def test_nan_params_rollback_discards_poisoned_checkpoints(clean8):
    """nan_params corrupts the state in place; no checkpoint at or after
    the anomaly survives (step 6 was never saved: the anomaly tripped
    first), every surviving one is finite, and the replayed curve is the
    clean run's, ``==``."""
    tmp, clean = clean8
    chaos = _run(_train_doc(tmp, "poison", 8, resilience={
        "sentinel": True, "faults": [{"kind": "nan_params", "at": 5}]}))
    assert chaos["rollback_count"] == 1
    assert _curve(chaos) == _curve(clean)
    ev = [e for e in _events(chaos) if e["kind"] == "anomaly"][0]
    assert ev["step"] == 5 and ev["restored_step"] == 4
    ckpts = list_checkpoints(str(tmp / "poison" / "ckpt"))
    assert [s for s, _ in ckpts] == [4, 6, 8]
    for _, path in ckpts:
        assert all(np.isfinite(read_leaf(path, e).double().numpy()).all()
                   for e in read_manifest(path)["leaves"].values())


def test_rollback_budget_exhaustion_is_fatal(tmp_path):
    with pytest.raises(AnomalyError, match="rollback"):
        _run(_train_doc(tmp_path, "doomed", 8, resilience={
            "sentinel": True, "max_rollbacks": 1,
            "faults": [{"kind": "nan_loss", "at": 3, "times": 0}]}))


def test_ckpt_io_fault_absorbed_by_retry_in_run(clean8):
    tmp, clean = clean8
    chaos = _run(_train_doc(tmp, "io", 6, resilience={
        "ckpt_retry": {"max_attempts": 3, "base_delay_s": 0.001},
        "faults": [{"kind": "ckpt_io", "at": 0}]}))
    assert chaos["retry_count"] == 1 and chaos["rollback_count"] == 0
    assert _curve(chaos) == {s: v for s, v in _curve(clean).items() if s <= 6}
    assert [s for s, _ in list_checkpoints(str(tmp / "io" / "ckpt"))] == \
        [2, 4, 6]


def test_preempt_then_resume_completes_budget(clean8):
    """A simulated SIGTERM at step 3 stops the run at the boundary with a
    final synchronous checkpoint and a resumable status; ``resume: auto``
    finishes the budget and the merged curve is the clean run's."""
    tmp, clean = clean8
    part = _run(_train_doc(tmp, "pre", 8, resilience={
        "faults": [{"kind": "preempt", "at": 3}]}))
    assert part["status"] == "preempted" and part["graceful_exit"] is True
    assert part["completed_steps"] == 3
    assert 3 in [s for s, _ in list_checkpoints(str(tmp / "pre" / "ckpt"))]
    with open(tmp / "pre" / "result.json") as f:
        assert json.load(f)["status"] == "preempted"
    res = _run(_train_doc(tmp, "pre", 8, resume="auto"))
    assert res["resumed_from"] == 3 and res["steps_this_run"] == 5
    assert _curve(part, res) == _curve(clean)


def test_real_sigterm_mid_run_preempts_and_resumes(clean8, monkeypatch):
    """A real SIGTERM sent to this process while the run API trains (from
    the gym's logger, after step 2's metrics) goes through the installed
    guard: the run stops at the next step boundary, commits, reports
    ``preempted`` with the signal, uninstalls its handlers, and resumes to
    the clean curve."""
    tmp, clean = clean8
    prev = signal.getsignal(signal.SIGTERM)
    setup = Gym.setup

    def setup_with_killer(gym):
        def kill_after_step_2(m):
            if m.get("step") == 2 and "loss" in m:
                os.kill(os.getpid(), signal.SIGTERM)
        gym.logger = kill_after_step_2
        return setup(gym)

    monkeypatch.setattr(Gym, "setup", setup_with_killer)
    part = _run(_train_doc(tmp, "sig", 8, resilience={"preemption": True}))
    monkeypatch.setattr(Gym, "setup", setup)
    assert signal.getsignal(signal.SIGTERM) == prev
    assert part["status"] == "preempted"
    stop = part["completed_steps"]
    assert 2 < stop < 8
    assert part["events"] == [{"kind": "preempt", "step": stop,
                               "signal": int(signal.SIGTERM),
                               "resumable": True}]
    res = _run(_train_doc(tmp, "sig", 8, resume="auto"))
    assert res["resumed_from"] == stop
    assert _curve(part, res) == _curve(clean)


def test_cli_preempted_run_exits_75_and_resumes(tmp_path, capsys):
    args = ["train", "--config", QUICKSTART, "--device", "cpu",
            "--set", "run.train.steps=6",
            "--set", f"dataset.config.prefix={tmp_path / 'qs'}",
            "--set", f"run.output_dir={tmp_path / 'out'}",
            "--set", "run.train.resume=auto"]
    rc = cli_main(args + ["--set", "run.train.resilience={faults: "
                                   "[{kind: preempt, at: 2}]}"])
    out = capsys.readouterr().out
    assert rc == PREEMPTED_EXIT_CODE == 75
    assert "preempted: resume with the same command (exit 75)" in out
    assert cli_main(args) == 0
    with open(tmp_path / "out" / "result.json") as f:
        res = json.load(f)
    assert res["resumed_from"] == 2 and res.get("status") is None


# ---------------------------------------------------------------------------
# the same chaos document in both packages
# ---------------------------------------------------------------------------
def _quickstart_doc(tmp, name, **train):
    doc = load_yaml(QUICKSTART)
    doc = apply_overrides(doc, parse_overrides(
        [f"dataset.config.prefix={tmp / 'qs'}",
         f"run.output_dir={tmp / name}", "run.train.steps=8",
         "gym.config.ckpt_every=2"]))
    doc["run"]["train"].update(train)
    return doc


@pytest.fixture(scope="module")
def jax_chaos(tmp_path_factory):
    """JAX's run of the chaos document (reduced Qwen, the quickstart's
    shape; ``nan_loss`` at 2, ``nan_params`` at 5, ``preempt`` at 7) and the
    initial params of JAX's gym (``PRNGKey(0)``) as numpy."""
    from repro.config.resolver import resolve_config as jax_resolve_config

    tmp = tmp_path_factory.mktemp("chaos")
    doc = _quickstart_doc(tmp, "jax", resilience=CHAOS)
    jax_components.register_all()
    jgym = jax_resolve_config({k: v for k, v in doc.items()
                               if k != "run"})["gym"]
    params = jax.tree_util.tree_map(np.asarray, jgym.setup()["params"])
    res = jax_api.execute_doc(doc, log=_quiet)
    return tmp, res, params


def test_chaos_document_matches_jax(jax_chaos, monkeypatch):
    """The port runs JAX's chaos document from JAX's initial params (the
    gym's seeded init, which the fresh-init rollback reuses, gives JAX's
    params): the same events (step, reason, restored step, rollbacks, data
    offset, firings), the same dispatched steps and goodput, losses within
    CURVE_TOL, and a step-4 checkpoint left finite."""
    tmp, jres, jparams = jax_chaos

    def init_from_jax(gym):
        params = params_from_jax(jparams)
        return {"params": params, "opt": gym.optimizer.init(params),
                "step": torch.zeros((), dtype=torch.int32)}

    monkeypatch.setattr(Gym, "_init_state", init_from_jax)
    res = _run(_quickstart_doc(tmp, "port", resilience=CHAOS))
    keys = ("kind", "fault", "index", "firing", "reason", "step",
            "restored_step", "rollbacks", "data_offset", "signal",
            "resumable")
    pick = lambda evs: [{k: e[k] for k in keys if k in e} for e in evs]  # noqa: E731
    assert pick(res["events"]) == pick(jres["events"])
    assert [e["restored_step"] for e in res["events"]
            if e["kind"] == "anomaly"] == [0, 4]
    assert res["steps_dispatched"] == jres["steps_dispatched"] == 12
    assert res["goodput"] == jres["goodput"]
    assert res["rollback_count"] == jres["rollback_count"] == 2
    assert res["status"] == jres["status"] == "preempted"
    assert res["completed_steps"] == jres["completed_steps"] == 7
    got, want = _curve(res), _curve(jres)
    assert sorted(got) == sorted(want) == list(range(1, 8))
    np.testing.assert_allclose([got[s] for s in sorted(got)],
                               [want[s] for s in sorted(want)],
                               atol=CURVE_TOL, rtol=0)
    path = str(tmp / "port" / "ckpt" / "step_00000004")
    assert all(np.isfinite(read_leaf(path, e).double().numpy()).all()
               for e in read_manifest(path)["leaves"].values())


# ---------------------------------------------------------------------------
# validate: documents with a resilience block or a fault schedule resolve
# ---------------------------------------------------------------------------
def test_validate_resolves_a_resilience_block(tmp_path, capsys):
    import yaml

    doc = load_yaml(QUICKSTART)
    doc["run"]["train"]["resilience"] = {
        "sentinel": {"spike_zscore": 6.0}, "max_rollbacks": 2,
        "ckpt_retry": {"max_attempts": 4},
        "faults": [{"kind": "nan_loss", "at": 5}]}
    doc["run"]["train"]["telemetry"]["profile"] = {"start_step": 3}
    doc["chaos"] = {"component_key": "fault_injector",
                    "variant_key": "schedule",
                    "config": {"faults": [{"kind": "preempt", "at": 9}]}}
    path = tmp_path / "quickstart_chaos.yaml"
    path.write_text(yaml.safe_dump(doc))
    rc = cli_main(["validate", str(path)])
    out = capsys.readouterr().out
    assert rc == 0 and out.startswith("ok ") and "kind=train" in out
    from repro_torch.config.resolver import resolve_config
    from repro_torch.core.components import register_all

    register_all()
    inj = resolve_config({"chaos": doc["chaos"]})["chaos"]
    assert isinstance(inj, FaultInjector) and inj.pending("preempt") == 1


def test_no_refusal_names_roadmap_a5():
    src = os.path.join(ROOT, "src", "repro_torch")
    hits = []
    for d, _, files in os.walk(src):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(d, f)) as fh:
                    if re.search(r"ROADMAP A5\b", fh.read()):
                        hits.append(f)
    assert hits == []


# ---------------------------------------------------------------------------
# serve: per-request deadlines + the stall watchdog
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def serve_model():
    """Reduced Qwen in both packages on JAX's ``PRNGKey(0)`` params."""
    from repro.configs import get_reduced as jax_get_reduced
    from repro.models import build_model as jax_build_model

    jm = jax_build_model(jax_get_reduced("qwen1p5_0p5b"))
    jp = jm.init(jax.random.PRNGKey(0))
    return {"jm": jm, "jp": jp,
            "model": build_model(get_reduced("qwen1p5_0p5b")),
            "params": params_from_jax(jax.tree_util.tree_map(np.asarray, jp))}


def test_serve_deadline_times_out_queued_request(serve_model):
    model, params = serve_model["model"], serve_model["params"]
    trace = synthetic_trace(2, model.cfg.vocab, seed=3, rate=0.0,
                            prompt_lens=(6,), gen_tokens=(4,), max_len=16)
    trace[0].deadline_s = 1e-9
    res = ServeEngine(model, params, n_slots=1, max_len=16).run(
        trace, realtime=True)
    assert res["timeouts"] == 1 and res["completed"] == 1
    rows = {r["id"]: r for r in res["requests"]}
    assert rows[0]["finish"] == "timeout" and rows[0]["n_gen"] == 0
    assert rows[1]["finish"] in ("eos", "length")


def test_serve_deadline_zero_means_no_deadline(serve_model):
    model, params = serve_model["model"], serve_model["params"]
    trace = synthetic_trace(2, model.cfg.vocab, seed=3, rate=0.0,
                            prompt_lens=(6,), gen_tokens=(4,), max_len=16)
    res = ServeEngine(model, params, n_slots=1, max_len=16).run(
        trace, realtime=False)
    assert res["timeouts"] == 0 and res["completed"] == 2


def test_serve_watchdog_trips_on_injected_stall(serve_model):
    model, params = serve_model["model"], serve_model["params"]
    trace = synthetic_trace(1, model.cfg.vocab, seed=3, rate=0.0,
                            prompt_lens=(6,), gen_tokens=(4,), max_len=16)
    engine = ServeEngine(
        model, params, n_slots=1, max_len=16, watchdog_s=0.1,
        fault_injector=FaultInjector([{"kind": "serve_stall", "at": 0,
                                       "seconds": 0.25}]))
    with pytest.raises(EngineError, match="watchdog"):
        engine.run(trace, realtime=False)
    with pytest.raises(EngineError, match=">= 0"):
        ServeEngine(model, params, n_slots=1, max_len=16, deadline_s=-1)


def _tick_of(err) -> int:
    return int(re.search(r"tick (\d+) took", str(err)).group(1))


def test_serve_stall_trips_the_watchdog_at_the_tick_jax_does(serve_model):
    """``serve_stall`` at call 2 (the third tick), in both engines on the
    same params and trace: both watchdogs name tick 3."""
    from repro.resilience import FaultInjector as JaxInjector
    from repro.serve.engine import EngineError as JaxEngineError
    from repro.serve.engine import ServeEngine as JaxServeEngine
    from repro.serve.workload import synthetic_trace as jax_synthetic_trace

    rows = [{"kind": "serve_stall", "at": 2, "seconds": 2.5}]
    kw = dict(seed=3, rate=0.0, prompt_lens=(6,), gen_tokens=(8,),
              max_len=16)
    model, params = serve_model["model"], serve_model["params"]
    engine = ServeEngine(model, params, n_slots=1, max_len=16,
                         watchdog_s=2.0,
                         fault_injector=FaultInjector(rows))
    with pytest.raises(EngineError, match="watchdog") as ours:
        engine.run(synthetic_trace(1, model.cfg.vocab, **kw), realtime=False)
    jengine = JaxServeEngine(serve_model["jm"], serve_model["jp"], n_slots=1,
                             max_len=16, watchdog_s=2.0,
                             fault_injector=JaxInjector(rows))
    with pytest.raises(JaxEngineError, match="watchdog") as theirs:
        jengine.run(jax_synthetic_trace(1, serve_model["jm"].cfg.vocab, **kw),
                    realtime=False)
    assert _tick_of(ours.value) == _tick_of(theirs.value) == 3


def test_serve_faults_run_through_the_run_api(tmp_path):
    """``run.serve.faults`` of ``serve_engine.yaml`` reach the engine: a
    stall at call 3 trips the watchdog at tick 4 (the chip smoke run's
    phase, with a watchdog far above a reduced tick on a loaded host)."""
    doc = load_yaml(SERVE_ENGINE)
    doc["run"]["output_dir"] = str(tmp_path / "serve")
    doc["run"]["serve"].update(
        watchdog_s=2.0, faults=[{"kind": "serve_stall", "at": 3,
                                 "seconds": 2.5}])
    with pytest.raises(EngineError, match="watchdog") as ei:
        api.execute_doc(doc, device="cpu", log=_quiet)
    assert _tick_of(ei.value) == 4
