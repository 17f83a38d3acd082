"""Declarative sweep CLI — DEPRECATED shim over ``python -m repro_torch
sweep`` (port of ``repro.launch.sweep``).

  PYTHONPATH=src python -m repro_torch.launch.sweep --config examples/configs/lr_sweep.yaml

The historic flags (``--list``, ``--report-only``, ``--redo``,
``--max-trials``, ``--output-dir``) are part of the new CLI's sweep
subcommand; this module simply prepends the subcommand and delegates.
"""
import sys


def main(argv=None) -> int:
    """DEPRECATED shim: delegates to ``python -m repro_torch sweep``."""
    import warnings

    warnings.warn(
        "python -m repro_torch.launch.sweep is deprecated; use "
        "`python -m repro_torch sweep --config <sweep.yaml>` (this shim "
        "delegates through the same Run API)", DeprecationWarning,
        stacklevel=2)
    from ..run.cli import main as cli_main

    if argv is None:
        argv = sys.argv[1:]
    return cli_main(["sweep", *argv])


if __name__ == "__main__":
    sys.exit(main())
