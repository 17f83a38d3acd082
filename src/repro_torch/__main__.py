"""``python -m repro_torch`` — the port's declarative entry point (see repro_torch.run.cli)."""
import sys

from .run.cli import main

if __name__ == "__main__":
    sys.exit(main())
