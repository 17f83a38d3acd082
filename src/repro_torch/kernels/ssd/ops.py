"""Public wrapper of the SSD chunk-scan kernel (port of
``repro.kernels.ssd.ops``).

``ssd_scan(x, dt, A, Bm, Cm, D, chunk=...)`` returns ``(y, h_final)``: the
scan's output in x's dtype and its final state ``[B, H, P, N]`` in f32, which
a prefill hands to decode.  For CUDA tensors it launches the hand-written
kernel in ``csrc/ssd_scan.cu`` (built with ``nvcc`` at first use, bound with
``ctypes``) or raises; for tensors on the CPU, and only then, it runs the
plain ``ref.ssd_chunked``.  The kernel reads x, dt, Bm and Cm in the model's
``[B, S, H, P]`` / ``[B, S, G, N]`` layouts through their batch and seq
strides, so the views that ``ssm_forward`` splits off its projection go in
without a copy.  One call launches three CUDA kernels (chunk states and
C·Bᵀ, the walk over chunks, the outputs); their f32 workspace (the chunk
states, 12.6 MB at Mamba2-780M's prefill of 1024 tokens) is allocated here
with ``torch.empty``, and the kernel allocates nothing.  ``ref.py``'s
``ssd_chunked_passes`` computes the same passes on the CPU, for the tests.

Differentiable on every device: ``ssd_scan`` always goes through
``_SSDScan``, an ``autograd.Function`` whose forward is the kernel (the
plain version on the CPU) and whose backward recomputes the gradients of x,
dt, A, Bm, Cm and D through ``ssd_chunked``, as JAX's ``custom_vjp`` does
(``repro.kernels.ssd.ops._bwd``).  ``h_final`` is marked
non-differentiable: JAX's ``ssd`` returns y only.  Inside a train step's
marked backward, each backward call is the phase ``step/ssd_backward``
(``telemetry.phases``).

The forward is the custom op ``repro_torch::ssd_scan``: the kernel for CUDA
tensors, ``ssd_chunked`` for CPU tensors, and for ``meta`` (and fake)
tensors its fake implementation, which makes ``(y, h_final)``'s shapes,
dtypes and device and launches nothing — how a dryrun traces a step with
no card.  Its FLOP formula (:func:`ssd_scan_flops`) is what the dryrun's
counter (``repro_torch.launch.hlo_analysis``) charges a call, on ``meta``
and on the card alike.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from ...telemetry import phases as PH
from ..build import load, refuse_dtensor
from .ref import ssd_chunked

#: largest chunk and state size the kernel takes
MAX_CHUNK = 128
MAX_STATE = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the last reset; ``chip_smoke.py`` sets it to 0
#: before driving the serve path and reads it after
launches = 0

_fn = None
_work_fn = None


def _kernel():
    global _fn, _work_fn
    if _fn is None:
        lib = load("ssd_scan")
        work = lib.ssd_scan_workspace_bytes
        work.argtypes = [ctypes.c_int] * 7
        work.restype = ctypes.c_longlong
        fn = lib.ssd_scan
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_longlong] * 8 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        _fn, _work_fn = fn, work
    return _fn, _work_fn


def _check(x, dt, A, Bm, Cm, D, chunk):
    refuse_dtensor("ssd_scan", (x, dt, A, Bm, Cm, D))
    if x.dim() != 4 or dt.dim() != 3 or Bm.dim() != 4 or Cm.dim() != 4:
        raise ValueError("ssd_scan: x [B,S,H,P], dt [B,S,H], Bm/Cm [B,S,G,N]")
    Bq, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if tuple(dt.shape) != (Bq, S, H) or tuple(Cm.shape) != tuple(Bm.shape) \
            or tuple(Bm.shape[:2]) != (Bq, S) or tuple(A.shape) != (H,) \
            or tuple(D.shape) != (H,):
        raise ValueError(f"ssd_scan: shapes do not match: x {tuple(x.shape)}, "
                         f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, Bm "
                         f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, D "
                         f"{tuple(D.shape)}")
    if G < 1 or H % G:
        raise ValueError(f"ssd_scan: {H} heads are not a multiple of {G} groups")
    if chunk < 1 or S % chunk:
        raise ValueError(f"ssd_scan: seq {S} not divisible by chunk {chunk}")
    if not (x.dtype == Bm.dtype == Cm.dtype) or x.dtype not in _DTYPE_CODES:
        raise TypeError(f"ssd_scan: x/Bm/Cm must share a dtype of "
                        f"{sorted(map(str, _DTYPE_CODES))}, got "
                        f"{x.dtype}/{Bm.dtype}/{Cm.dtype}")
    if any(t.dtype != torch.float32 for t in (dt, A, D)):
        raise TypeError(f"ssd_scan: dt, A and D must be float32, got "
                        f"{dt.dtype}/{A.dtype}/{D.dtype}")
    if len({t.device for t in (x, dt, A, Bm, Cm, D)}) != 1:
        raise ValueError("ssd_scan: inputs on different devices")


def ssd_scan(x, dt, A, Bm, Cm, D, *, chunk: int = 128):
    """x [B,S,H,P]; dt [B,S,H] f32 (post-softplus); A [H] f32 (negative);
    Bm/Cm [B,S,G,N]; D [H] f32.  Returns (y [B,S,H,P] in x's dtype,
    h_final [B,H,P,N] f32), starting from a zero state.

    The checks (shapes, dtypes, ``S % chunk``) hold on the CPU too, so the
    CPU tests refuse what the card would.  On the card the kernel also needs
    ``chunk <= MAX_CHUNK``, ``N <= MAX_STATE``, and the head and feature axes
    of x, and the group and state axes of Bm/Cm, contiguous (the batch and
    seq axes may have any stride).
    """
    _check(x, dt, A, Bm, Cm, D, chunk)
    return _SSDScan.apply(x, dt, A, Bm, Cm, D, int(chunk))


def ssd_scan_flops(x_shape, b_shape, chunk: int) -> int:
    """The FLOPs of one forward at these shapes: the four contractions of
    the plain version, ``ssd_chunked``, in each of its ``S / chunk``
    chunks (C·Bᵀ, the intra-chunk product, the inter-chunk read of the
    carried state and the state update), 2·M·N·K each."""
    Bq, S, H, P = x_shape
    G, N = b_shape[2], b_shape[3]
    Q = chunk
    per_chunk = G * Q * Q * N + H * Q * Q * P + 2 * H * Q * P * N
    return 2 * Bq * (S // Q) * per_chunk


class _SSDScan(torch.autograd.Function):
    """Kernel forward; backward = vjp of ``ssd_chunked``'s y (recomputed)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, chunk):
        ctx.save_for_backward(x, dt, A, Bm, Cm, D)
        ctx.chunk = chunk
        y, h_final = torch.ops.repro_torch.ssd_scan(x, dt, A, Bm, Cm, D,
                                                    chunk)
        ctx.mark_non_differentiable(h_final)
        return y, h_final

    @staticmethod
    def backward(ctx, gy, _gh):
        with PH.mark("step/ssd_backward", nested=True), torch.enable_grad():
            ins = [t.detach().requires_grad_(need) for t, need in
                   zip(ctx.saved_tensors, ctx.needs_input_grad)]
            y, _ = ssd_chunked(*ins, chunk=ctx.chunk)
            wrt = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wrt, gy))
        return tuple(next(grads) if t.requires_grad else None
                     for t in ins) + (None,)


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def _forward(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
             chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward on checked inputs: the kernel for CUDA tensors, the plain
    version for tensors on the CPU."""
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, Bm, Cm, D, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    Bq, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if chunk > MAX_CHUNK or N > MAX_STATE:
        raise ValueError(f"ssd_scan: chunk {chunk} / state {N} above the "
                         f"kernel's {MAX_CHUNK} / {MAX_STATE}")
    if x.stride(3) != 1 or x.stride(2) != P or dt.stride(2) != 1 \
            or any(t.stride(3) != 1 or t.stride(2) != N for t in (Bm, Cm)) \
            or not (A.is_contiguous() and D.is_contiguous()):
        raise ValueError("ssd_scan: x's [H, P], Bm/Cm's [G, N] and dt's head "
                         "axis must be contiguous")
    y = torch.empty((Bq, S, H, P), dtype=x.dtype, device=x.device)
    h_final = torch.empty((Bq, H, P, N), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, h_final.zero_()
    global launches
    fn, work_bytes = _kernel()
    n_work = work_bytes(Bq, S, H, P, G, N, int(chunk))
    if n_work < 0:
        raise ValueError(f"ssd_scan: the kernel does not take shape "
                         f"{tuple(x.shape)} / {tuple(Bm.shape)}, chunk {chunk}")
    work = torch.empty((n_work,), dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), D.data_ptr(), y.data_ptr(), h_final.data_ptr(),
            Bq, S, H, P, G, N, int(chunk), _DTYPE_CODES[x.dtype],
            x.stride(0), x.stride(1), dt.stride(0), dt.stride(1),
            Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
            work.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {rc}")
    launches += 1
    return y, h_final


@_forward.register_fake
def _forward_fake(x, dt, A, Bm, Cm, D, chunk):
    Bq, S, H, P = x.shape
    N = Bm.shape[3]
    return (x.new_empty((Bq, S, H, P)),
            x.new_empty((Bq, H, P, N), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.ssd_scan)
def _ssd_flop_formula(x_shape, dt_shape, a_shape, b_shape, c_shape, d_shape,
                      chunk, *args, **kwargs) -> int:
    return ssd_scan_flops(x_shape, b_shape, chunk)
