"""The port's flash-attention wrapper at head dim 80 (Zamba2's shared
attention block) against the JAX package's Pallas kernel.

On the CPU the wrapper runs its plain version; JAX runs its Pallas kernel in
interpret mode, as ``tests/test_kernels.py`` does.  Both get the same numpy
inputs made from a seed.  Tolerances are the JAX kernel test's: 1e-5 in
f32 (two f32 softmax-weighted sums taken in another order) and 2.5e-2 in
bf16 (outputs of size ~1 rounded once to bf16, plus the order of the f32
sums); the gradients 2e-4, as ``tests/test_kernels.py``'s (both recompute
the same plain f32 function).  The CUDA kernel at dh 80 runs only on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash.ops import flash_attention as jax_flash_attention
from repro_torch.kernels.flash import ops

# B, Sq, Skv, H, K, dh, causal, window, dtype
DH80_CASES = [
    (1, 256, 256, 4, 4, 80, True, 0, jnp.float32),
    (1, 256, 256, 4, 4, 80, True, 0, jnp.bfloat16),
    (2, 192, 192, 4, 2, 80, True, 0, jnp.float32),       # GQA
    (2, 192, 192, 4, 2, 80, True, 0, jnp.bfloat16),
    (1, 300, 300, 4, 2, 80, True, 64, jnp.float32),      # window, ragged
    (1, 300, 300, 4, 2, 80, True, 64, jnp.bfloat16),
    (1, 128, 384, 4, 1, 80, False, 0, jnp.bfloat16),     # MQA, Sq != Skv
    (1, 128, 384, 4, 2, 80, True, 32, jnp.float32),      # causal + window
]
_TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
GRAD_TOL = 2e-4


def _case_id(c):
    return (f"B{c[0]}S{c[1]}x{c[2]}H{c[3]}K{c[4]}d{c[5]}"
            f"{'c' if c[6] else 'b'}w{c[7]}{c[8].__name__}")


def _inputs(case, seed=0):
    B, Sq, Skv, H, K, dh = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, dh), dtype=np.float32),
            rng.standard_normal((B, Skv, K, dh), dtype=np.float32),
            rng.standard_normal((B, Skv, K, dh), dtype=np.float32))


def test_dh80_is_a_supported_head_dim():
    assert 80 in ops.SUPPORTED_HEAD_DIMS


@pytest.mark.parametrize("case", DH80_CASES, ids=_case_id)
def test_port_flash_matches_jax_kernel_at_dh80(case):
    causal, window, dt = case[6:]
    qn, kn, vn = _inputs(case)
    want = jax_flash_attention(*(jnp.asarray(a).astype(dt)
                                 for a in (qn, kn, vn)),
                               causal=causal, window=window)
    tdt = _TORCH_DTYPE[dt]
    before = ops.launches
    got = ops.flash_attention(*(torch.from_numpy(a).to(tdt)
                                for a in (qn, kn, vn)),
                              causal=causal, window=window)
    assert ops.launches == before   # CPU tensors: plain version, no launch
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    tol = 2.5e-2 if dt == jnp.bfloat16 else 1e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 48)])
def test_dh80_gradients_match_jax_custom_vjp(causal, window):
    """The wrapper's ``autograd.Function`` backward against ``jax.grad`` of
    JAX's ``custom_vjp`` at dh 80, GQA, f32."""
    qn, kn, vn = _inputs((1, 160, 160, 4, 2, 80), seed=3)
    want = jax.grad(lambda q, k, v: jnp.sum(jax_flash_attention(
        q, k, v, causal=causal, window=window) ** 2), argnums=(0, 1, 2))(
        *map(jnp.asarray, (qn, kn, vn)))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (qn, kn, vn)]
    out = ops.flash_attention(*ins, causal=causal, window=window)
    got = torch.autograd.grad(torch.sum(out ** 2), ins)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   atol=GRAD_TOL)
