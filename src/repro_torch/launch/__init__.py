"""Port of ``repro.launch``."""
