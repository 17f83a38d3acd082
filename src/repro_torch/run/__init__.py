"""The port's run API: one document grammar; the train, warmstart, serve,
sft, dpo, bench and sweep kinds, each a registry component
(:mod:`repro_torch.run.kinds`); run artifacts and replay."""
from .config import (KINDS, SETTINGS_SCHEMAS, BenchSettings,  # noqa: F401
                     RunConfig, RunError, ServeSettings, TelemetrySettings,
                     TrainSettings, WarmstartKindSettings, WarmstartSettings,
                     parse_run_doc, register_run_settings)
