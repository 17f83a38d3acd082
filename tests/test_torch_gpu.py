"""The port's CUDA kernel on the card, against its plain PyTorch version.

Every test here is marked ``gpu`` and skips on a host without a CUDA device
(the kernel has no CPU mode).  The file imports neither JAX nor the JAX
package, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

(``--noconftest``: ``tests/conftest.py`` imports JAX.)  Tolerances are the
JAX kernel tests': 1e-5 in f32, whose path multiplies in f32, and 2.5e-2 in
bf16, where the outputs and the tensor-core path's probabilities are rounded
to bf16.
"""
import pytest
import torch

from repro_torch.kernels.flash import ops
from repro_torch.kernels.flash.ref import attention_ref

f32, bf16 = torch.float32, torch.bfloat16
# FLASH_CASES of tests/test_kernels.py (test_torch_flash.py holds the two equal)
FLASH_CASES = [
    # B, Sq, Skv, H, K, dh, causal, window, dtype
    (2, 256, 256, 4, 2, 64, True, 0, f32),
    (1, 300, 300, 4, 4, 64, True, 0, f32),
    (2, 256, 256, 8, 2, 64, True, 64, bf16),
    (1, 128, 128, 2, 1, 128, False, 0, f32),
    (1, 128, 384, 4, 4, 64, False, 0, f32),
    (2, 192, 192, 4, 2, 32, True, 0, bf16),
]
# bf16 takes the tensor-core path: its ragged edge, dh=128, MQA, Sq != Skv
# with causal + window, and the serving slice's prefill shape
EXTRA_CASES = [
    (1, 300, 300, 4, 4, 64, True, 0, bf16),
    (1, 128, 128, 2, 1, 128, False, 0, bf16),
    (1, 128, 384, 4, 2, 64, True, 32, bf16),
    (1, 128, 384, 4, 2, 64, True, 32, f32),
    (1, 1024, 1024, 16, 16, 64, True, 0, bf16),
]

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel has no CPU mode")
    return torch.device("cuda")


def _case_id(c):
    return (f"B{c[0]}S{c[1]}x{c[2]}H{c[3]}K{c[4]}d{c[5]}"
            f"{'c' if c[6] else 'b'}w{c[7]}{str(c[8]).split('.')[-1]}")


@pytest.mark.parametrize("case", FLASH_CASES + EXTRA_CASES, ids=_case_id)
def test_kernel_vs_plain(case, cuda):
    B, Sq, Skv, H, K, dh, causal, window, dt = case
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((B, Sq, H, dh), generator=gen, device=cuda, dtype=dt)
    k = torch.randn((B, Skv, K, dh), generator=gen, device=cuda, dtype=dt)
    v = torch.randn((B, Skv, K, dh), generator=gen, device=cuda, dtype=dt)
    before = ops.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert got.dtype == dt and got.shape == q.shape
    want = attention_ref(q, k, v, causal=causal, window=window)
    tol = 2.5e-2 if dt == bf16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_misaligned_input_is_refused(cuda):
    flat = torch.zeros(1 + 64 * 4 * 64, device=cuda, dtype=bf16)
    q = flat[1:].view(1, 64, 4, 64)          # contiguous, 2 bytes off
    k = torch.zeros((1, 64, 4, 64), device=cuda, dtype=bf16)
    before = ops.launches
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(q, k, k)
    assert ops.launches == before


def test_reduced_serve_goes_through_the_kernel(cuda):
    """The static-batch serve path on the card launches the kernel once per
    layer per admission (the requests plus the warm-up's one)."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.serve import serve_benchmark
    from repro_torch.models import build_model

    cfg = get_reduced("qwen1p5_0p5b").with_(use_flash_kernel=True)
    model = build_model(cfg)
    before = ops.launches
    res = serve_benchmark(model, batch=2, prompt_len=24, gen=4, device=cuda,
                          log=lambda m: None)
    assert ops.launches - before == cfg.n_layers * (2 + 1)
    assert all(len(ids) == 4 and all(0 <= t < cfg.vocab for t in ids)
               for ids in res["generated_ids"])


def test_flash_prefill_matches_plain_prefill(cuda):
    """Reduced qwen, bf16 through 2 layers: logits of size ~1 (a bf16 step
    of 2**-7) may differ by a few steps where the kernel and the plain path
    round at other places."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    from repro_torch.serve.engine import load_params

    cfg = get_reduced("qwen1p5_0p5b")
    params = load_params(build_model(cfg), seed=0, device=cuda)
    tokens = torch.randint(3, cfg.vocab, (1, 40), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(1))
    flash, _ = build_model(cfg.with_(use_flash_kernel=True)).prefill(
        params, {"tokens": tokens})
    plain, _ = build_model(cfg).prefill(params, {"tokens": tokens})
    torch.testing.assert_close(flash.float(), plain.float(), atol=3e-2, rtol=0)
