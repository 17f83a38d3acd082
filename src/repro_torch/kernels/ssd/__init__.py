"""SSD chunk scan: CUDA kernel (csrc/), wrapper (ops), plain version (ref)."""
from .ops import ssd_scan  # noqa: F401
from .ref import ssd_chunked, ssd_recurrence_ref  # noqa: F401
