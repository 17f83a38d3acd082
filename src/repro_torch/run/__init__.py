"""The port's run API: one document grammar, the serve kind so far."""
from .config import RunConfig, RunError, ServeSettings, parse_run_doc  # noqa: F401
