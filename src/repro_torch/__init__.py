"""PyTorch and CUDA port of the ``repro`` package, for one NVIDIA H100.

A package of its own beside ``repro`` (the JAX reference): it imports
``torch`` and never ``jax``, and nothing of ``repro``.  Module names follow
``repro``'s, so each module's counterpart is found by its path.  Entry
points run on the card unless the caller passes ``device="cpu"``.
"""
