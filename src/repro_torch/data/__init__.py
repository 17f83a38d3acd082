"""Datasets and loaders (``repro.data`` counterpart)."""
