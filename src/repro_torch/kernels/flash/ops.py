"""Public wrapper of the flash-attention forward kernel
(port of ``repro.kernels.flash.ops``).

``flash_attention(q, k, v, ...)`` keeps the JAX signature and the
``[B, S, H, dh]`` layout.  For CUDA tensors it launches the hand-written
kernel in ``csrc/flash_fwd.cu`` (built with ``nvcc`` at first use, bound
with ``ctypes``) or raises; for tensors on the CPU, and only then, it runs
the plain version in ``ref.py``.  The kernel reads q/k/v in that layout
through their strides, so no transpose to the Pallas kernel's
``[B·K·G, S, dh]`` layout is made in device memory.

Differentiable on every device: ``flash_attention`` always goes through
``_FlashAttention``, an ``autograd.Function`` whose forward is the kernel
(the plain version on the CPU) and whose backward recomputes the gradient
through ``ref.attention_ref``, as JAX's ``custom_vjp`` does
(``repro.kernels.flash.ops._bwd``): no score tensor is kept between the
passes, and the CPU tests run the same backward as the card.

The forward is the custom op ``repro_torch::flash_fwd``: the kernel for
CUDA tensors, the plain version for CPU tensors, and for ``meta`` (and
fake) tensors its fake implementation, which makes the output's shape,
dtype and device and launches nothing — how a dryrun traces a step with no
card.  Its FLOP formula (:func:`flash_fwd_flops`) is what the dryrun's
counter (``repro_torch.launch.hlo_analysis``) charges a call, on ``meta``
and on the card alike.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from ..build import load, refuse_dtensor
from .ref import attention_ref

#: head dims the kernel is instantiated for
SUPPORTED_HEAD_DIMS = (32, 64, 80, 128, 160)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last reset; ``chip_smoke.py`` sets it to 0
#: before driving the serve path and reads it after
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = load("flash_fwd").flash_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(q, k, v, causal, window, block_q, block_kv):
    refuse_dtensor("flash_attention", (q, k, v))
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be [B, S, heads, dh]")
    B, Sq, H, dh = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != dh:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    K = k.shape[2]
    if K < 1 or H % K:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {K} kv heads")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention: q/k/v must share a dtype of "
                        f"{sorted(map(str, _DTYPE_CODES))}, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if window < 0 or block_q < 1 or block_kv < 1:
        raise ValueError("flash_attention: window >= 0 and positive blocks")
    if dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    block_q: int = 128, block_kv: int = 128):
    """q [B, Sq, H, dh]; k/v [B, Skv, K, dh]; returns [B, Sq, H, dh].

    The checks (dtype f32 or bf16, ``dh`` in ``SUPPORTED_HEAD_DIMS``,
    contiguous inputs) are the kernel's and hold on the CPU too, so the CPU
    tests refuse what the card would.  Causal and window masks compare 0-based q and k indices with the same
    origin, as the Pallas kernel does, also when ``Sq != Skv``.
    ``block_q``/``block_kv`` are the Pallas kernel's tile sizes, kept for
    the signature; the CUDA kernel fixes its own tiles (q tiles of 64 rows,
    kv tiles of 64).  bf16 inputs go through the tensor cores, f32 inputs
    through f32 FMAs (see the note at the top of ``csrc/flash_fwd.cu``).
    """
    _check(q, k, v, causal, window, block_q, block_kv)
    return _FlashAttention.apply(q, k, v, bool(causal), int(window))


def flash_fwd_flops(q_shape, k_shape, causal: bool = True,
                    window: int = 0) -> int:
    """The FLOPs of one forward at these shapes: the matmuls of the plain
    version, ``attention_ref`` (q·kᵀ and p·v over every (query, key) pair,
    2·B·H·Sq·Skv·dh each).  The kernel skips the key tiles that the causal
    or window mask empties entirely; that saving is not modelled, as JAX's
    dryrun counts its plain path's dots (``causal`` and ``window`` are
    taken for the signature)."""
    B, Sq, H, dh = q_shape
    Skv = k_shape[1]
    return 4 * B * H * Sq * Skv * dh


class _FlashAttention(torch.autograd.Function):
    """Kernel forward; backward = vjp of ``attention_ref`` (recomputed)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return torch.ops.repro_torch.flash_fwd(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need)
                   for t, need in zip((q, k, v), ctx.needs_input_grad)]
            out = attention_ref(*ins, causal=ctx.causal, window=ctx.window)
            wrt = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, g))
        return tuple(next(grads) if t.requires_grad else None
                     for t in ins) + (None, None)


@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=())
def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
             window: int) -> torch.Tensor:
    """The forward on checked inputs: the kernel for CUDA tensors, the plain
    version for tensors on the CPU."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must start 16-byte aligned "
                         "(the kernel loads 16 bytes at a time)")
    B, Sq, H, dh = q.shape
    Skv, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    global launches
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                       B, Sq, Skv, H, K, dh, _DTYPE_CODES[q.dtype],
                       int(bool(causal)), int(window), stream)
    if rc != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {rc}")
    launches += 1
    return out


@_forward.register_fake
def _forward_fake(q, k, v, causal, window):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def _flash_flop_formula(q_shape, k_shape, v_shape, causal, window, *args,
                        **kwargs) -> int:
    return flash_fwd_flops(q_shape, k_shape, causal, window)
