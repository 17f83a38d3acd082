"""The SSD kernel's decomposition, emulated on the CPU, against JAX.

``repro_torch.kernels.ssd.ref.ssd_chunked_passes`` computes the scan as
``csrc/ssd_scan.cu`` does: chunk states, the walk over chunks, then the
outputs, with every f32 operand of a product split into bf16 high and low
parts as the kernel feeds the tensor cores.  Here it is held against JAX's
``repro.models.ssm.ssd_chunked`` on the same numpy inputs, so the algebra
and the split's accuracy are checked before the card.

Tolerances are ``chip_smoke.py``'s for the kernel: y within 3e-5 of its
largest element in f32 and 3e-2 in bf16 (y rounded once to bf16); the final
state, f32 on both sides, within 1e-4 of its largest element.  The hi/lo
split represents an operand to about 2**-17 of its size, well inside both.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.ssm as JS
from repro_torch.kernels.ssd.ref import ssd_chunked, ssd_chunked_passes
from test_kernels import SSD_CASES

Y_TOL = {jnp.float32: 3e-5, jnp.bfloat16: 3e-2}
STATE_TOL = 1e-4
_TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}

# SSD_CASES of tests/test_kernels.py, then the shapes the card's tests add:
# one chunk, several chunks with B 2 and G 4, a chunk and a P that are no
# multiples of 16 or 32
CASES = [c[:7] for c in SSD_CASES] + [
    (1, 128, 4, 64, 1, 128, 128),
    (2, 384, 8, 32, 4, 64, 128),
    (2, 96, 8, 16, 4, 16, 32),
    (1, 72, 4, 48, 2, 24, 24),
]


def _inputs(B, S, H, P, G, N, seed=4):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    return (f(B, S, H, P), np.log1p(np.exp(f(B, S, H))), -np.exp(0.5 * f(H)),
            0.3 * f(B, S, G, N), 0.3 * f(B, S, G, N), 1.0 + 0.1 * f(H))


def _rel(got, want, rel):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _id(c):
    return "B{}S{}H{}P{}G{}N{}c{}".format(*c)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=_id)
def test_passes_match_jax_ssd_chunked(case, dtype):
    B, S, H, P, G, N, chunk = case
    x, dt, A, Bm, Cm, D = _inputs(B, S, H, P, G, N)
    jx, jB, jC = (jnp.asarray(a).astype(dtype) for a in (x, Bm, Cm))
    want_y, want_h = JS.ssd_chunked(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC,
                                    jnp.asarray(D), chunk=chunk)
    tdt = _TORCH_DTYPE[dtype]
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    got_y, got_h = ssd_chunked_passes(t(x).to(tdt), t(dt), t(A), t(Bm).to(tdt),
                                      t(Cm).to(tdt), t(D), chunk=chunk)
    assert got_y.dtype == tdt and got_y.shape == (B, S, H, P)
    assert got_h.dtype == torch.float32 and got_h.shape == (B, H, P, N)
    _rel(got_y.float(), want_y, Y_TOL[dtype])
    _rel(got_h, want_h, STATE_TOL)


def test_split_is_needed_for_the_state(monkeypatch):
    """Without the low parts (one bf16 rounding of each f32 operand) the
    final state misses the 1e-4 bound the split holds: the split is what
    keeps the tensor-core products at f32 accuracy."""
    import repro_torch.kernels.ssd.ref as ref

    x, dt, A, Bm, Cm, D = (torch.from_numpy(np.array(a))
                           for a in _inputs(1, 256, 4, 64, 1, 64))
    _, want_h = ssd_chunked(x, dt, A, Bm, Cm, D, chunk=64)
    _, got_h = ssd_chunked_passes(x, dt, A, Bm, Cm, D, chunk=64)
    scale = float(want_h.abs().max())
    assert float((got_h - want_h).abs().max()) <= STATE_TOL * scale
    monkeypatch.setattr(ref, "_parts",
                        lambda v, split: [v.float().to(torch.bfloat16).float()])
    _, rough_h = ssd_chunked_passes(x, dt, A, Bm, Cm, D, chunk=64)
    assert float((rough_h - want_h).abs().max()) > STATE_TOL * scale


def test_passes_refuse_a_ragged_chunk():
    x, dt, A, Bm, Cm, D = (torch.from_numpy(np.array(a))
                           for a in _inputs(1, 40, 2, 8, 1, 8))
    with pytest.raises(ValueError, match="divisible"):
        ssd_chunked_passes(x, dt, A, Bm, Cm, D, chunk=16)
