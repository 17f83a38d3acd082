"""Plain PyTorch reference of the benchmark's configurations.  It imports
nothing of the program: it works the model out again from the seeded
weights and the token rows the benchmark made.

One module per architecture type, ``<arch_type>.py``, found by the
configuration's ``arch_type``: its parameter tree (``param_specs``, and
``stacks``, the leaves held stacked ``[L, ...]``), its layers (``body``)
and its model FLOPs a token (``flops_per_token``).  ``lm.py`` holds what
every language model shares: the embedding, the head, the loss and AdamW.
"""
import importlib


def model(arch):
    """The reference module of ``arch``'s architecture type."""
    name = f"{__name__}.{arch['arch_type']}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ValueError(f"no reference for arch type "
                         f"{arch['arch_type']!r}") from e
