"""The port's run API: one document grammar; the train, warmstart and
serve kinds; run artifacts and replay."""
from .config import (RunConfig, RunError, ServeSettings,  # noqa: F401
                     TelemetrySettings, TrainSettings, WarmstartKindSettings,
                     WarmstartSettings, parse_run_doc)
