"""The port's flash-attention wrapper against the JAX package's Pallas kernel.

On the CPU the wrapper runs its plain version (``repro_torch.kernels.flash.ref``)
and the JAX side runs the Pallas kernel in interpret mode, as
``tests/test_kernels.py`` does.  Both get the same numpy inputs made from a
seed (bf16 cases round the same f32 draws to bf16 in each package).
Tolerances are the JAX kernel test's: 1e-5 in f32 (two f32 softmax-weighted
sums taken in another order) and 2.5e-2 in bf16 (outputs of size ~1 rounded
once to bf16, a step of 2**-8..2**-7, plus the order of the f32 sums).

The kernel itself runs only on the card: ``tests/test_torch_gpu.py`` holds
it against this plain version there, and ``chip_smoke.py`` does too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash.ops import flash_attention as jax_flash_attention
from repro_torch.kernels.flash import ops
from test_kernels import FLASH_CASES

_TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _case_id(c):
    return (f"B{c[0]}S{c[1]}x{c[2]}H{c[3]}K{c[4]}d{c[5]}"
            f"{'c' if c[6] else 'b'}w{c[7]}{c[8].__name__}")


def _inputs(case, seed=0):
    B, Sq, Skv, H, K, dh = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, dh), dtype=np.float32),
            rng.standard_normal((B, Skv, K, dh), dtype=np.float32),
            rng.standard_normal((B, Skv, K, dh), dtype=np.float32))


def _tol(dt):
    return 2.5e-2 if dt == jnp.bfloat16 else 1e-5


@pytest.mark.parametrize("case", FLASH_CASES, ids=_case_id)
def test_port_flash_matches_jax_kernel(case):
    causal, window, dt = case[6:]
    qn, kn, vn = _inputs(case)
    want = jax_flash_attention(*(jnp.asarray(a).astype(dt) for a in (qn, kn, vn)),
                               causal=causal, window=window)
    tdt = _TORCH_DTYPE[dt]
    before = ops.launches
    got = ops.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (qn, kn, vn)),
                              causal=causal, window=window)
    assert ops.launches == before   # CPU tensors: plain version, no launch
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    tol = _tol(dt)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("bad", ["dh96", "dtype_mix", "f16", "heads", "strided",
                                 "rank", "window"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q = torch.zeros((1, 8, 4, 64))
    k = torch.zeros((1, 8, 2, 64))
    v = torch.zeros((1, 8, 2, 64))
    kw = {}
    if bad == "dh96":      # no instantiation (dh 160 has one: StableLM-2-12B)
        q, k, v = q[..., :16].repeat(1, 1, 1, 6), k[..., :16].repeat(1, 1, 1, 6), \
            v[..., :16].repeat(1, 1, 1, 6)
    elif bad == "dtype_mix":
        k = k.to(torch.bfloat16)
    elif bad == "f16":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "heads":
        k = torch.zeros((1, 8, 3, 64))
        v = torch.zeros((1, 8, 3, 64))
    elif bad == "strided":
        q = torch.zeros((1, 4, 8, 64)).transpose(1, 2)
    elif bad == "rank":
        q = q[0]
    elif bad == "window":
        kw["window"] = -1
    with pytest.raises((ValueError, TypeError)):
        ops.flash_attention(q, k, v, **kw)


def test_wrapper_on_cpu_never_builds_or_launches():
    case = FLASH_CASES[0]
    qn, kn, vn = _inputs(case)
    before = ops.launches
    ops.flash_attention(torch.from_numpy(qn), torch.from_numpy(kn),
                        torch.from_numpy(vn))
    assert ops.launches == before
    assert ops._fn is None          # the CUDA library was never loaded


def test_gpu_cases_are_the_jax_kernel_cases():
    """``tests/test_torch_gpu.py`` (no JAX there: it runs on the card's
    machine) keeps its own copy of ``FLASH_CASES``; it must stay the same."""
    from test_torch_gpu import FLASH_CASES as GPU_CASES

    name = {jnp.float32: "float32", jnp.bfloat16: "bfloat16"}
    want = [c[:8] + (name[c[8]],) for c in FLASH_CASES]
    assert [c[:8] + (str(c[8]).split(".")[-1],) for c in GPU_CASES] == want
