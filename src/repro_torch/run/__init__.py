"""The port's run API: one document grammar, the train and serve kinds."""
from .config import (RunConfig, RunError, ServeSettings,  # noqa: F401
                     TelemetrySettings, TrainSettings, parse_run_doc)
