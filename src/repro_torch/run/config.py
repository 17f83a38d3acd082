"""Run documents of the port (the ``train``, ``warmstart``, ``serve``,
``sft``, ``dpo``, ``bench``, ``dryrun``, ``trace`` and ``sweep`` kinds of
``repro.run.config``).

A run document is a YAML mapping with a ``run:`` header naming the kind and
a per-kind settings section; everything else is the component graph the
resolver builds.  ``train`` drives the resolved gym for a total budget of
``steps`` steps with its telemetry, resuming (``resume``) or warmstarting
(``warmstart``) from a checkpoint; ``warmstart`` is the same with flat
settings; ``serve`` runs the static-batch shim (``batch``, ``prompt_len``,
``gen``, ``seed``, ``ckpt``) or, with ``engine: true``, the
continuous-batching engine over a seeded ``workload`` with per-request
``sampling`` and a ``faults`` schedule; ``sft`` and ``dpo`` post-train the
resolved gym like ``train``, optionally through LoRA adapters (``lora``),
DPO against a frozen reference and with pairs sampled ``onpolicy``;
``bench`` times the resolved gym's hot path (``steps`` after ``warmup``,
in ``windows``); ``dryrun`` and ``trace`` trace one step of the resolved
``arch``, ``shape``, ``mesh``, ``plan`` and ``precision`` on a fake world
(``grad_accum``; ``top`` rows of the schedule); ``sweep`` carries a
sweep spec (``repro_torch.sweep``), free-form as in JAX.  The
``resilience`` block of the train-shaped kinds (sentinel, rollback,
preemption, checkpoint retries, faults) and ``telemetry.profile`` (the
profiler window) are JAX's grammar, with JAX's error messages.  A
document without a ``run:`` section is a ``train`` run when it has a
``gym`` and a sweep when it has a sweep spec, as in JAX.  Settings of
a later slice are recognised and refused naming it, so a document never
runs with settings ignored.  A new kind is a settings schema (:func:`register_run_settings`)
plus an executor, registered together by
:func:`repro_torch.run.kinds.register_run_kind`.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Type


class RunError(Exception):
    pass


def _validate_train_like(kind: str, s) -> None:
    """Shared resume/warmstart validation for train-shaped kinds."""
    if isinstance(s.resume, str):
        if s.resume != "auto":
            raise RunError(f"run.{kind}.resume must be true|false|auto, "
                           f"got {s.resume!r}")
    elif not isinstance(s.resume, bool):
        raise RunError(f"run.{kind}.resume must be true|false|auto, "
                       f"got {s.resume!r}")
    if isinstance(s.warmstart, dict):
        s.warmstart = _coerce_block(kind, "warmstart", s.warmstart,
                                    WarmstartSettings)
    elif s.warmstart is not None and not isinstance(s.warmstart,
                                                    WarmstartSettings):
        raise RunError(f"run.{kind}.warmstart must be a mapping "
                       f"(source/optimizer/strict)")
    if s.warmstart is not None and s.resume:
        raise RunError(f"run.{kind}: resume and warmstart are mutually "
                       f"exclusive (resume continues THIS run; warmstart "
                       f"starts a new one from another run's checkpoint)")


# ---------------------------------------------------------------------------
# resilience (fault tolerance) — the train-shaped kinds
# ---------------------------------------------------------------------------
def _validate_faults(where: str, faults: Any) -> list:
    """The chaos-schedule grammar: a list of ``{kind, at, times, seconds}``
    rows, each validated against the known fault kinds."""
    if faults is None:
        faults = []
    if isinstance(faults, dict):
        faults = [faults]
    if not isinstance(faults, (list, tuple)):
        raise RunError(f"{where} must be a list of "
                       f"{{kind, at, times, seconds}} rows")
    from ..resilience.faults import FaultSpec

    rows = []
    for row in faults:
        if not isinstance(row, dict):
            raise RunError(f"{where}: rows must be mappings, got {row!r}")
        try:
            FaultSpec(**row)
        except (TypeError, ValueError) as e:
            raise RunError(f"{where}: {e}") from e
        rows.append(dict(row))
    return rows


@dataclasses.dataclass
class SentinelSettings:
    """``run.<kind>.resilience.sentinel``: anomaly detection over flushed
    metric points — NaN/Inf always trips when ``nan``; a loss-spike trips
    when its z-score against the rolling ``window`` exceeds
    ``spike_zscore`` (0 disables; ``min_history`` guards noisy starts)."""

    metric: str = "loss"
    nan: bool = True
    spike_zscore: float = 0.0
    window: int = 32
    min_history: int = 8


@dataclasses.dataclass
class RetrySettings:
    """``run.<kind>.resilience.ckpt_retry``: bounded exponential backoff
    with deterministic jitter for transient IO.  ``max_attempts`` counts
    the first try."""

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: float = 0.25

    def __post_init__(self):
        if self.max_attempts < 1:
            raise RunError(f"retry.max_attempts must be >= 1, "
                           f"got {self.max_attempts}")


@dataclasses.dataclass
class ResilienceSettings:
    """``run.<kind>.resilience``: the fault-tolerance block.

    ``sentinel`` arms anomaly detection (rollback to the newest committed
    checkpoint BEFORE the anomaly, up to ``max_rollbacks``;
    ``skip_window: true`` additionally skips the anomalous data window on
    replay — which changes the curve, so it is off by default).
    ``preemption`` installs the SIGTERM/SIGINT graceful-exit guard.
    ``ckpt_retry`` wraps checkpoint IO in retry-with-backoff.  ``faults``
    is the deterministic chaos schedule (see
    :mod:`repro_torch.resilience.faults`)."""

    sentinel: Any = None          # mapping/true -> SentinelSettings
    max_rollbacks: int = 3
    skip_window: bool = False
    preemption: bool = True       # install the SIGTERM/SIGINT guard
    ckpt_retry: Any = None        # mapping/true -> RetrySettings
    faults: Any = ()              # chaos rows: {kind, at, times, seconds}

    def __post_init__(self):
        if self.max_rollbacks < 0:
            raise RunError(f"resilience.max_rollbacks must be >= 0, "
                           f"got {self.max_rollbacks}")
        if self.sentinel is True:
            self.sentinel = SentinelSettings()
        elif self.sentinel is not None and not isinstance(
                self.sentinel, SentinelSettings):
            self.sentinel = _coerce_block("resilience", "sentinel",
                                          self.sentinel, SentinelSettings)
        if self.ckpt_retry is True:
            self.ckpt_retry = RetrySettings()
        elif self.ckpt_retry is not None and not isinstance(
                self.ckpt_retry, RetrySettings):
            self.ckpt_retry = _coerce_block("resilience", "ckpt_retry",
                                            self.ckpt_retry, RetrySettings)
        self.faults = _validate_faults("resilience.faults", self.faults)


def _coerce_resilience(kind: str, value: Any) -> Any:
    """``resilience:`` block: absent/None => no fault-tolerance wiring;
    ``true`` => all defaults (sentinel stays off until configured)."""
    if value is None or isinstance(value, ResilienceSettings):
        return value
    if value is True:
        return ResilienceSettings()
    return _coerce_block(kind, "resilience", value, ResilienceSettings)


# ---------------------------------------------------------------------------
# telemetry (observability) — every kind
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ProfileSettings:
    """``run.<kind>.telemetry.profile``: wrap a window of steps in
    ``torch.profiler``.  The chrome trace lands under
    ``<output_dir>/profile`` (or ``dir``) and its path is recorded as a
    telemetry event and in the result (``profile_trace``)."""

    start_step: int = 1
    num_steps: int = 1
    dir: str = ""                 # default: <output_dir>/profile

    def __post_init__(self):
        if self.start_step < 1 or self.num_steps < 1:
            raise RunError(f"telemetry.profile start_step/num_steps must be "
                           f">= 1, got {self.start_step}/{self.num_steps}")


@dataclasses.dataclass
class TelemetrySettings:
    """``run.<kind>.telemetry``: the unified observability block, on by
    default.  ``telemetry: false`` disables it; ``sink`` picks a sink
    variant; ``spans: false`` keeps metric and event rows but drops the
    per-step phase spans; ``profile`` arms the ``torch.profiler``
    window."""

    enabled: bool = True
    sink: str = "jsonl"
    path: str = ""                # file sinks; default <output_dir>/telemetry.*
    prefix: str = ""              # stdout sink
    sinks: Any = ()               # multi sink: nested {sink, path, prefix} rows
    spans: bool = True
    profile: Any = None           # mapping -> ProfileSettings

    _KNOWN_SINKS = ("jsonl", "csv", "stdout", "multi", "memory")

    def __post_init__(self):
        if self.sink not in self._KNOWN_SINKS:
            raise RunError(f"telemetry.sink must be one of "
                           f"{list(self._KNOWN_SINKS)}, got {self.sink!r}")
        if self.sink == "multi":
            if not isinstance(self.sinks, (list, tuple)) or not self.sinks:
                raise RunError("telemetry.sink 'multi' needs a non-empty "
                               "'sinks' list")
            self.sinks = [s if isinstance(s, dict) else {"sink": str(s)}
                          for s in self.sinks]
        else:
            self.sinks = list(self.sinks or ())
        if self.profile is not None and not isinstance(self.profile,
                                                       ProfileSettings):
            self.profile = _coerce_block("telemetry", "profile",
                                         self.profile, ProfileSettings)


def _coerce_telemetry(kind: str, value: Any) -> TelemetrySettings:
    """absent/None/true => defaults (on); false => disabled."""
    if isinstance(value, TelemetrySettings):
        return value
    if value is None or value is True:
        return TelemetrySettings()
    if value is False:
        return TelemetrySettings(enabled=False)
    if not isinstance(value, dict):
        raise RunError(f"run.{kind}.telemetry must be a mapping or a bool")
    fields = {f.name for f in dataclasses.fields(TelemetrySettings)}
    unknown = set(value) - fields
    if unknown:
        raise RunError(f"run.{kind}.telemetry: unknown keys {sorted(unknown)}; "
                       f"accepted: {sorted(fields)}")
    return TelemetrySettings(**value)


@dataclasses.dataclass
class WarmstartSettings:
    """``run.train.warmstart``: initialize from another run's checkpoint.
    ``optimizer: fresh`` takes only the params (a new run with pretrained
    weights); ``carry`` also restores the optimizer moments and master
    weights.  ``strict: false`` keeps freshly-initialized values for leaves
    the checkpoint does not have (partial warmstart, e.g. a resized
    head)."""

    source: str = ""              # ckpt dir or one committed step_* dir
    optimizer: str = "fresh"      # fresh | carry
    strict: bool = True

    def __post_init__(self):
        if not self.source:
            raise RunError("warmstart needs 'source': a checkpoint "
                           "directory or committed step_XXXXXXXX dir")
        if self.optimizer not in ("fresh", "carry"):
            raise RunError(f"warmstart.optimizer must be fresh|carry, "
                           f"got {self.optimizer!r}")


@dataclasses.dataclass
class TrainSettings:
    """``run.train``: drive the resolved gym.

    ``steps`` is the TOTAL step budget: a run resumed at committed step R
    trains the remaining ``steps - R`` (so an interrupted run and an
    uninterrupted one of the same budget produce the same loss curve).
    ``resume`` is ``false`` | ``true``/``auto`` (find the latest committed
    checkpoint in the gym's checkpoint dir).  ``warmstart`` (mutually
    exclusive with resume) initializes from another run's checkpoint.
    ``resilience`` is the fault-tolerance block (:class:`ResilienceSettings`)."""

    steps: int = 100
    resume: Any = False           # false | true | "auto"
    warmstart: Any = None         # mapping -> WarmstartSettings
    gym_key: str = "gym"          # top-level graph entry that is the gym
    resilience: Any = None        # mapping -> ResilienceSettings
    telemetry: Any = None         # mapping/bool -> TelemetrySettings

    def __post_init__(self):
        self.resilience = _coerce_resilience("train", self.resilience)
        if self.steps < 0:
            raise RunError(f"run.train.steps must be >= 0, got {self.steps}")
        self.telemetry = _coerce_telemetry("train", self.telemetry)
        _validate_train_like("train", self)


@dataclasses.dataclass
class LoRASettings:
    """``run.sft.lora`` / ``run.dpo.lora``: adapter injection knobs.

    ``targets`` are fnmatch patterns over the last path component of base
    param leaves (only matrix leaves are eligible).  Omitting the whole
    ``lora:`` block means full-parameter fine-tuning."""

    rank: int = 8
    alpha: float = 16.0
    targets: Any = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down")

    def __post_init__(self):
        if self.rank < 1:
            raise RunError(f"lora.rank must be >= 1, got {self.rank}")
        if isinstance(self.targets, str):
            self.targets = [self.targets]
        if not isinstance(self.targets, (list, tuple)) or not self.targets \
                or not all(isinstance(t, str) for t in self.targets):
            raise RunError(f"lora.targets must be a non-empty list of "
                           f"patterns, got {self.targets!r}")
        self.targets = list(self.targets)  # lists: YAML-dump friendly


def _coerce_lora(kind: str, value: Any) -> Any:
    """``lora:`` block: absent/None => full fine-tune (no adapters)."""
    if value is None or isinstance(value, LoRASettings):
        return value
    if value is True:
        return LoRASettings()
    return _coerce_block(kind, "lora", value, LoRASettings)


@dataclasses.dataclass
class SFTSettings:
    """``run.sft``: supervised fine-tuning through the resolved gym.

    Same step semantics as ``run.train`` (``steps`` is the total budget,
    ``resume: auto`` continues from the latest committed checkpoint,
    ``warmstart:`` loads the pretrained base).  With a ``lora:`` block the
    gym's model is wrapped in adapters and only they train; the final
    adapter subtree is checkpointed on its own under ``adapter_dir``
    (default ``<output_dir>/adapter``) and ``export_merged: true``
    additionally writes base+adapter folded into the flat deploy export.
    The dataset must emit ``loss_mask`` batches (the ``sft_*`` dataset
    variants) for prompt-loss masking — a plain LM dataset trains
    unmasked."""

    steps: int = 100
    resume: Any = False           # false | true | "auto"
    warmstart: Any = None         # mapping -> WarmstartSettings
    gym_key: str = "gym"
    lora: Any = None              # mapping -> LoRASettings; None => full FT
    adapter_dir: str = ""         # default: <output_dir>/adapter
    export_merged: bool = False
    resilience: Any = None        # mapping -> ResilienceSettings
    telemetry: Any = None         # mapping/bool -> TelemetrySettings

    def __post_init__(self):
        _validate_train_like("sft", self)
        self.lora = _coerce_lora("sft", self.lora)
        self.resilience = _coerce_resilience("sft", self.resilience)
        self.telemetry = _coerce_telemetry("sft", self.telemetry)


@dataclasses.dataclass
class OnPolicySettings:
    """``run.dpo.onpolicy``: sample preference pairs from the (warmstarted)
    policy through the serve engine instead of using the graph's dataset."""

    n_prompts: int = 8
    prompt_len: int = 16
    gen_tokens: int = 16
    temperature: float = 0.8
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    n_slots: int = 4

    def __post_init__(self):
        if self.n_prompts < 1:
            raise RunError("run.dpo.onpolicy.n_prompts must be >= 1")
        if self.temperature <= 0:
            raise RunError("run.dpo.onpolicy.temperature must be > 0 "
                           "(greedy sampling yields identical pairs)")


@dataclasses.dataclass
class DPOSettings:
    """``run.dpo``: direct preference optimization.

    The reference policy is reconstructed, never stored: under ``lora:``
    it is the frozen base (zeroed adapters), so ``resume: auto`` works;
    full-parameter DPO keeps a copy of the warmstarted params as the
    reference and therefore cannot resume (the pre-training params would
    be gone).  ``onpolicy:`` replaces the graph dataset with pairs
    sampled from the policy via the serve engine."""

    steps: int = 100
    resume: Any = False
    warmstart: Any = None
    gym_key: str = "gym"
    lora: Any = None
    adapter_dir: str = ""
    beta: float = 0.1
    onpolicy: Any = None          # mapping -> OnPolicySettings
    resilience: Any = None        # mapping -> ResilienceSettings
    telemetry: Any = None         # mapping/bool -> TelemetrySettings

    def __post_init__(self):
        _validate_train_like("dpo", self)
        self.lora = _coerce_lora("dpo", self.lora)
        self.resilience = _coerce_resilience("dpo", self.resilience)
        self.telemetry = _coerce_telemetry("dpo", self.telemetry)
        if self.beta <= 0:
            raise RunError(f"run.dpo.beta must be > 0, got {self.beta}")
        if self.onpolicy is not None and not isinstance(self.onpolicy,
                                                        OnPolicySettings):
            self.onpolicy = _coerce_block("dpo", "onpolicy", self.onpolicy,
                                          OnPolicySettings)
        if self.resume and self.lora is None:
            raise RunError(
                "run.dpo: resume requires a lora: block — the frozen "
                "reference is reconstructed as the zero-adapter base, which "
                "only exists when the base is frozen; full-parameter DPO "
                "cannot resume")


@dataclasses.dataclass
class WarmstartKindSettings:
    """``run.warmstart``: train from another run's checkpoint (the
    ``warmstart`` kind, sugar over ``run.train.warmstart``)."""

    source: str = ""              # checkpoint dir or committed step_* dir
    steps: int = 100
    optimizer: str = "fresh"      # fresh | carry
    strict: bool = True
    gym_key: str = "gym"


@dataclasses.dataclass
class BenchSettings:
    """``run.bench``: measure the train hot path (the first step's time,
    steady-state step time, tokens/sec) for the resolved gym and keep it as
    an artifact.

    Writes ``BENCH_<name>.json`` into ``bench_dir`` besides the run
    directory's ``result.json``.  ``bench_dir`` keeps JAX's default ``"."``
    (so the run document's fingerprint is JAX's), but the port reads
    ``"."`` as the run's ``output_dir`` (see ``run.kinds.execute_bench``);
    ``""`` writes none.
    """

    steps: int = 20               # measured steps (post-warmup)
    warmup: int = 3               # steps between the first and measurement
    windows: int = 5              # median-of-windows steady-state timing
    gym_key: str = "gym"          # top-level graph entry that is the gym
    bench_dir: str = "."          # where BENCH_<name>.json lands
    telemetry: Any = None         # mapping/bool -> TelemetrySettings

    def __post_init__(self):
        if self.windows < 1:
            raise RunError(f"run.bench.windows must be >= 1, "
                           f"got {self.windows}")
        self.telemetry = _coerce_telemetry("bench", self.telemetry)


@dataclasses.dataclass
class SamplingSettings:
    """``run.serve.sampling``: default sampling knobs for engine workloads.

    ``temperature <= 0`` is greedy; ``top_k <= 0`` and ``top_p: 1.0``
    disable those filters."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if not 0.0 < self.top_p <= 1.0:
            raise RunError(f"run.serve.sampling.top_p must be in (0, 1], "
                           f"got {self.top_p}")
        if self.top_k < 0:
            raise RunError(f"run.serve.sampling.top_k must be >= 0, "
                           f"got {self.top_k}")


@dataclasses.dataclass
class WorkloadSettings:
    """``run.serve.workload``: the seeded synthetic trace the engine serves.

    ``rate`` is the Poisson arrival rate in requests/second (0 = all at
    t=0); ``prompt_lens``/``gen_tokens`` are per-request choice sets;
    ``prefix_len > 0`` makes it a shared-prefix trace whose ``prompt_lens``
    are the tails after the prefix."""

    n_requests: int = 8
    rate: float = 0.0
    prompt_lens: Any = (16, 32)
    gen_tokens: Any = (8, 16)
    seed: int = 0
    realtime: bool = True
    prefix_len: int = 0
    n_prefixes: int = 1

    def __post_init__(self):
        if self.n_requests < 1:
            raise RunError("run.serve.workload.n_requests must be >= 1")
        if self.prefix_len < 0:
            raise RunError(f"run.serve.workload.prefix_len must be >= 0, "
                           f"got {self.prefix_len}")
        if self.n_prefixes < 1:
            raise RunError(f"run.serve.workload.n_prefixes must be >= 1, "
                           f"got {self.n_prefixes}")
        for field in ("prompt_lens", "gen_tokens"):
            val = getattr(self, field)
            if isinstance(val, int):
                val = (val,)
            if not isinstance(val, (list, tuple)) or not val or not all(
                    isinstance(v, int) and v > 0 for v in val):
                raise RunError(f"run.serve.workload.{field} must be a "
                               f"non-empty list of positive ints, got {val!r}")
            setattr(self, field, list(val))


def _coerce_block(kind: str, name: str, value: Any, cls: Type) -> Any:
    """Nested settings block: mapping -> dataclass (None -> defaults)."""
    if value is None:
        return cls()
    if isinstance(value, cls):
        return value
    if not isinstance(value, dict):
        raise RunError(f"run.{kind}.{name} must be a mapping")
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(value) - fields
    if unknown:
        raise RunError(f"run.{kind}.{name}: unknown keys {sorted(unknown)}; "
                       f"accepted: {sorted(fields)}")
    return cls(**value)


@dataclasses.dataclass
class ServeSettings:
    """``run.serve``: inference serving.

    ``engine: false`` (default) is the static-batch shim — ``batch``
    identical greedy requests of ``prompt_len`` random tokens, ``gen``
    tokens each.  ``engine: true`` runs the continuous-batching engine:
    ``n_slots`` cache slots, a ``workload`` trace with mid-flight
    admission, per-request ``sampling``, EOS stopping, the paged knobs
    (``block_len`` -1 auto / 0 dense, ``n_blocks``, ``prefill_chunk``,
    ``prefix_cache``), deadlines and the watchdog, and a
    ``BENCH_serve_<name>.json`` artifact (``compare_static`` adds the
    equal-occupancy static-shim baseline).  ``bench_dir`` keeps JAX's
    default ``"."`` (so the run document's fingerprint is JAX's), but the
    port reads ``"."`` as the run's ``output_dir`` (see
    ``run.api.execute_serve``).  ``ckpt`` restores the params of a
    training checkpoint (either format); ``faults`` is the engine's chaos
    schedule (``serve_stall`` rows).
    """

    batch: int = 4
    prompt_len: int = 32
    gen: int = 16
    ckpt: str = ""
    seed: int = 0
    engine: bool = False
    n_slots: int = 4
    max_len: int = 0              # 0 => derived from the workload
    eos_id: int = -1              # -1 => requests only stop on budget
    block_len: int = -1           # paged KV page size; -1 auto, 0 dense pool
    n_blocks: int = 0             # 0 => (n_slots + 1) * pages-per-request
    prefill_chunk: int = 0        # 0 => 2 * block_len (must divide by it)
    prefix_cache: bool = True     # radix prefix sharing (paged mode only)
    sampling: Any = None          # mapping -> SamplingSettings
    workload: Any = None          # mapping -> WorkloadSettings
    compare_static: bool = True
    bench_dir: str = "."          # where BENCH_serve_<name>.json lands
    deadline_s: float = 0.0       # per-request wall deadline (0 = none)
    watchdog_s: float = 0.0       # no-progress tick watchdog (0 = off)
    faults: Any = ()              # chaos rows (serve_stall)
    telemetry: Any = None         # mapping/bool -> TelemetrySettings

    def __post_init__(self):
        self.telemetry = _coerce_telemetry("serve", self.telemetry)
        self.sampling = _coerce_block("serve", "sampling", self.sampling,
                                      SamplingSettings)
        self.workload = _coerce_block("serve", "workload", self.workload,
                                      WorkloadSettings)
        self.faults = _validate_faults("run.serve.faults", self.faults)
        if min(self.batch, self.prompt_len, self.gen) < 1:
            raise RunError(f"run.serve: batch/prompt_len/gen must be >= 1, got "
                           f"{self.batch}/{self.prompt_len}/{self.gen}")
        if self.deadline_s < 0 or self.watchdog_s < 0:
            raise RunError(f"run.serve.deadline_s/watchdog_s must be >= 0, "
                           f"got {self.deadline_s}/{self.watchdog_s}")
        if self.engine and self.n_slots < 1:
            raise RunError(f"run.serve.n_slots must be >= 1, "
                           f"got {self.n_slots}")
        if self.block_len < -1:
            raise RunError(f"run.serve.block_len must be -1 (auto), 0 "
                           f"(dense), or a page size, got {self.block_len}")
        if self.n_blocks < 0 or self.prefill_chunk < 0:
            raise RunError(f"run.serve.n_blocks/prefill_chunk must be >= 0, "
                           f"got {self.n_blocks}/{self.prefill_chunk}")


@dataclasses.dataclass
class RunConfig:
    kind: str
    name: str
    output_dir: str
    settings: Any
    graph: Dict[str, Any]
    doc: Dict[str, Any]           # the normalized document, as JAX's: the
                                  # run section with every setting filled
    config_dir: str = "."         # base dir for relative paths (warmstart
                                  # source, replay)


@dataclasses.dataclass
class DryrunSettings:
    """``run.dryrun``: the per-device cost of one traced step of the
    resolved components, on a fake world of the mesh's size.

    Graph entries: ``arch`` (arch_config, required), ``shape`` (required),
    ``mesh`` (mesh_provider, default production), ``plan`` (sharding_plan,
    default per-arch), ``precision`` (precision policy, optional).
    """

    grad_accum: int = 1


@dataclasses.dataclass
class TraceSettings:
    """``run.trace``: the collective schedule of one traced step.

    Graph entries: same as ``dryrun``.
    """

    top: int = 20
    grad_accum: int = 1


#: kind -> settings dataclass (None => a free-form mapping)
SETTINGS_SCHEMAS: Dict[str, Optional[Type]] = {
    "train": TrainSettings, "warmstart": WarmstartKindSettings,
    "serve": ServeSettings, "sft": SFTSettings, "dpo": DPOSettings,
    "bench": BenchSettings, "dryrun": DryrunSettings, "trace": TraceSettings,
    "sweep": None}

KINDS = tuple(SETTINGS_SCHEMAS)


def register_run_settings(kind: str, settings_cls: Optional[Type]) -> None:
    """Add a new run kind's settings schema (new kinds are a registry entry
    plus this schema — no new script)."""
    SETTINGS_SCHEMAS[kind] = settings_cls


_PLAN_KEYS = {"plan", "sharding_plan"}
_NODE_KEYS = {"component_key", "instance_key", "pass_type"}


def _normalize_inline_plans(obj: Any) -> Any:
    """Declarative custom plans: a ``plan:`` / ``sharding_plan:`` entry whose
    value is a plain field mapping (``{tp: true, pp: 2, ...}``) becomes a
    ``sharding_plan/custom`` component node, so run YAML can express novel
    plan compositions inline — not only catalog names.  Field validation
    happens in :func:`repro_torch.sharding.plans.custom_plan` at resolve
    time."""
    if isinstance(obj, list):
        return [_normalize_inline_plans(v) for v in obj]
    if not isinstance(obj, dict):
        return obj
    out: Dict[str, Any] = {}
    for k, v in obj.items():
        if k in _PLAN_KEYS and isinstance(v, dict) and not (_NODE_KEYS & set(v)):
            out[k] = {"component_key": "sharding_plan",
                      "variant_key": "custom", "config": dict(v)}
        else:
            out[k] = _normalize_inline_plans(v)
    return out


def _infer_kind(doc: Dict[str, Any]) -> Optional[str]:
    """Classify a legacy document with no ``run:`` section."""
    if "sweep" in doc or "axes" in doc or "base" in doc or "base_config" in doc:
        return "sweep"
    if "gym" in doc:
        return "train"
    return None


def parse_run_doc(doc: Dict[str, Any], *, kind: Optional[str] = None,
                  default_name: str = "run",
                  config_dir: str = ".") -> RunConfig:
    """Parse (and normalize) a run document.  ``kind`` is the CLI
    subcommand, if any; ``default_name`` names a run whose document does
    not (the CLI passes the YAML file's stem, as JAX's)."""
    if not isinstance(doc, dict):
        raise RunError("run document must be a mapping")
    doc = dict(doc)
    run_sec = dict(doc.pop("run", None) or {})
    if not run_sec and _infer_kind(doc) == "sweep" \
            and kind not in (None, "sweep"):
        raise RunError(f"document is a sweep spec but was launched as "
                       f"{kind!r}")
    doc_kind = run_sec.get("kind") or kind or _infer_kind(doc)
    if kind is not None and doc_kind != kind:
        raise RunError(f"document declares kind {doc_kind!r} but was "
                       f"launched as {kind!r}")
    if doc_kind not in SETTINGS_SCHEMAS:
        raise RunError(f"unknown run kind {doc_kind!r}; the port runs "
                       f"{sorted(SETTINGS_SCHEMAS)}")
    unknown = set(run_sec) - {"kind", "name", "output_dir", doc_kind}
    if unknown:
        raise RunError(f"run section has unknown keys {sorted(unknown)}")
    section = dict(run_sec.get(doc_kind) or {})
    cls = SETTINGS_SCHEMAS[doc_kind]
    name = str(run_sec.get("name") or default_name)
    if doc_kind == "sweep":
        return _parse_sweep(run_sec, doc, name, config_dir)
    doc = _normalize_inline_plans(doc)
    output_dir = str(run_sec.get("output_dir")
                     or os.path.join("results", "runs", name))
    normalized_run = {"kind": doc_kind, "name": name, "output_dir": output_dir}
    if cls is None:  # schema-less kind: keep whatever mapping was given
        settings = section
        if section:
            normalized_run[doc_kind] = dict(section)
    else:
        fields = {f.name for f in dataclasses.fields(cls)}
        if set(section) - fields:
            raise RunError(f"run.{doc_kind}: unknown settings "
                           f"{sorted(set(section) - fields)}; accepted: "
                           f"{sorted(fields)}")
        settings = cls(**section)
        normalized_run[doc_kind] = dataclasses.asdict(settings)
    return RunConfig(kind=doc_kind, name=name, output_dir=output_dir,
                     settings=settings, graph=doc,
                     doc={"run": normalized_run, **doc},
                     config_dir=config_dir)


def _parse_sweep(run_sec: Dict[str, Any], graph: Dict[str, Any], name: str,
                 config_dir: str) -> RunConfig:
    """A sweep document (JAX's): the spec lives in ``run.sweep`` or is the
    document body (a top-level ``sweep:`` mapping, or its keys), and the
    sweep writes to ``results/sweeps/<name>`` unless it names a
    directory."""
    sweep_doc = run_sec.get("sweep") or graph
    if not sweep_doc:
        raise RunError("sweep run has no sweep spec (run.sweep section "
                       "or document body)")
    settings = dict(sweep_doc)
    output_dir = run_sec.get("output_dir")
    if not output_dir:
        body = settings.get("sweep", settings)
        output_dir = body.get("output_dir") or os.path.join(
            "results", "sweeps", str(body.get("name") or name))
    normalized_run: Dict[str, Any] = {"kind": "sweep", "name": name,
                                      "output_dir": output_dir}
    if run_sec.get("sweep"):
        normalized_run["sweep"] = dict(run_sec["sweep"])
    return RunConfig(kind="sweep", name=name, output_dir=str(output_dir),
                     settings=settings, graph=graph,
                     doc={"run": normalized_run, **graph},
                     config_dir=config_dir)
