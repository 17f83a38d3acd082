"""Port of ``repro.train``."""
