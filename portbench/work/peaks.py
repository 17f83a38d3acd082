"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at its
700 W limit)."""

#: bf16 / fp16 tensor-core FLOP/s, without 2:4 sparsity
PEAK_FLOPS_BF16 = 989.4e12
#: HBM3 bytes/s
HBM_BYTES_S = 3.35e12


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the chip could take: bytes at the HBM rate or
    operations at the bf16 peak, whichever is longer."""
    return max(n_bytes / HBM_BYTES_S, n_ops / PEAK_FLOPS_BF16)
