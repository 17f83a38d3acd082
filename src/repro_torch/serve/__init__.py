"""Port of ``repro.serve``."""
