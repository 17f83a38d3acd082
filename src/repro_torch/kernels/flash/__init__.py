"""Flash-attention forward: CUDA kernel (csrc/), wrapper (ops), plain version (ref)."""
from .ops import flash_attention  # noqa: F401
from .ref import attention_ref  # noqa: F401
