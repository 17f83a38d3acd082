"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here is marked ``gpu`` and skips on a host without a CUDA device
(the kernel has no CPU mode).  The file imports neither JAX nor the JAX
package, so it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

(``--noconftest``: ``tests/conftest.py`` imports JAX.)  Tolerances are the
JAX kernel tests'.  Flash: 1e-5 in f32, whose path multiplies in f32, and
2.5e-2 in bf16, where the outputs and the tensor-core path's probabilities
are rounded to bf16.  SSD: y within 3e-5 * max|ref| in f32 and 3e-2 * max|ref|
in bf16; the final state, f32 on both sides from the same inputs, within
1e-4 * max|ref| (see ``SSD_STATE_TOL``).
"""
import pytest
import torch

from repro_torch.kernels.flash import ops
from repro_torch.kernels.flash.ref import attention_ref
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd.ref import ssd_chunked

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
    # a ragged last kv tile behind a full ring stage, and dh 128 at the
    # slice's length: the K/V ring's prefetch of partial and wide tiles
    (1, 1000, 1000, 16, 16, 64, True, 0, bf16),
    (1, 1024, 1024, 16, 16, 128, True, 0, bf16),
    # dh 80 (Zamba2's shared block): its prefill shape, GQA with a window
    # and a ragged edge in both paths
    (1, 1024, 1024, 32, 32, 80, True, 0, bf16),
    (1, 300, 300, 4, 2, 80, True, 64, bf16),
    (1, 300, 300, 4, 2, 80, True, 64, f32),
    (2, 192, 192, 4, 2, 80, True, 0, bf16),
    # dh 160 (StableLM-2-12B, 32 query heads over 8 kv heads): its prefill
    # shape, a window and a ragged edge in both paths, MQA with Sq != Skv
    (1, 1024, 1024, 32, 8, 160, True, 0, bf16),
    (1, 300, 300, 4, 2, 160, True, 64, bf16),
    (1, 300, 300, 4, 2, 160, True, 64, f32),
    (1, 128, 384, 4, 1, 160, False, 0, bf16),
    # Whisper-tiny's decoder prefill (6 heads of 64, 416 = 6.5 q tiles: the
    # paired q tiles of dh <= 64 meet a ragged last one), and LLaVA-NeXT-
    # 34B's (56 query heads over 8 kv heads, a group of 7) at its prefill
    # length and a ragged one, in both paths
    (8, 416, 416, 6, 6, 64, True, 0, bf16),
    (4, 1024, 1024, 56, 8, 128, True, 0, bf16),
    (1, 600, 600, 56, 8, 128, True, 0, bf16),
    (1, 600, 600, 56, 8, 128, True, 0, f32),
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


def test_encdec_prefill_on_the_card_matches_the_cpu(cuda):
    """Reduced Whisper, bf16: the card's prefill (its decoder's
    self-attention through the kernel) against the CPU's (the plain
    version) on the same params, frames and prompt, within the bound of
    ``test_flash_prefill_matches_plain_prefill``; the caches too."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    from repro_torch.serve.engine import load_params

    cfg = get_reduced("whisper_tiny").with_(use_flash_kernel=True)
    model = build_model(cfg)
    params = load_params(model, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(3, cfg.vocab, (2, 40), generator=gen),
             "frames": 0.02 * torch.randn((2, cfg.encoder_frames,
                                           cfg.d_model), generator=gen)}
    want, want_c = model.prefill(params, batch, max_len=48)
    before = ops.launches
    on_card = {k: v.to(cuda) for k, v in batch.items()}
    got, got_c = model.prefill({k: _to(v, cuda) for k, v in params.items()},
                               on_card, max_len=48)
    torch.cuda.synchronize()
    assert ops.launches - before == cfg.n_layers
    torch.testing.assert_close(got.float().cpu(), want.float(), atol=3e-2,
                               rtol=0)
    for key in ("cross_k", "cross_v"):
        torch.testing.assert_close(got_c[key].float().cpu(),
                                   want_c[key].float(), atol=3e-2, rtol=3e-2)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# SSD_CASES of tests/test_kernels.py, then the serving slice's shape (Mamba2
# 780M: H 48, P 64, N 128, chunk 128) and a multi-group bf16 case
SSD_CASES = [
    # B, S, H, P, G, N, chunk, dtype
    (2, 256, 4, 64, 1, 64, 128, f32),
    (1, 128, 4, 32, 2, 16, 32, f32),
    (2, 256, 8, 64, 1, 128, 128, bf16),
    (1, 96, 2, 16, 1, 8, 32, f32),
    (1, 1024, 48, 64, 1, 128, 128, bf16),
    (2, 384, 8, 32, 4, 64, 128, bf16),
    # a chunk that is no multiple of 16 and a P that is no multiple of 32
    (1, 72, 4, 48, 2, 24, 24, f32),
    # the kernel's passes: a single chunk (no state enters any chunk), B 2
    # with 3 chunks and 4 groups (states passed across batch and group),
    # and the slice's shape in f32
    (1, 128, 4, 64, 1, 128, 128, bf16),
    (2, 96, 8, 16, 4, 16, 32, f32),
    (1, 1024, 48, 64, 1, 128, 128, f32),
]
# the final state is f32 on both sides, from the same inputs: each element
# is a sum over up to S decayed f32 products taken in another order, whose
# rounding stays under S * 2**-24 (6e-5 at S = 1024) of the largest state
SSD_STATE_TOL = 1e-4


def _ssd_id(c):
    return (f"B{c[0]}S{c[1]}H{c[2]}P{c[3]}G{c[4]}N{c[5]}c{c[6]}"
            f"{str(c[7]).split('.')[-1]}")


def _ssd_inputs(case, device, seed=1):
    B, S, H, P, G, N, chunk, dt_ = case
    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=device)  # noqa: E731
    x = rnd(B, S, H, P).to(dt_)
    dt = torch.nn.functional.softplus(rnd(B, S, H))
    A = -torch.exp(rnd(H) * 0.5)
    Bm = (rnd(B, S, G, N) * 0.3).to(dt_)
    Cm = (rnd(B, S, G, N) * 0.3).to(dt_)
    D = torch.ones((H,), device=device)
    return x, dt, A, Bm, Cm, D


@pytest.mark.parametrize("case", SSD_CASES, ids=_ssd_id)
def test_ssd_kernel_vs_plain(case, cuda):
    chunk, dt_ = case[6], case[7]
    args = _ssd_inputs(case, cuda)
    before = ssd_ops.launches
    y, h = ssd_ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_ops.launches == before + 1
    y_ref, h_ref = ssd_chunked(*args, chunk=chunk)
    assert y.dtype == dt_ and y.shape == args[0].shape
    assert h.dtype == f32 and h.shape == h_ref.shape
    tol = (3e-2 if dt_ == bf16 else 3e-5) * float(y_ref.float().abs().max())
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol, rtol=0)
    htol = SSD_STATE_TOL * float(h_ref.abs().max())
    torch.testing.assert_close(h, h_ref, atol=htol, rtol=0)


def test_ssd_kernel_reads_strided_views(cuda):
    """x, Bm and Cm as ``ssm_forward`` makes them: views split off one
    projection, with a seq stride wider than their rows."""
    B, S, H, P, G, N = 2, 128, 4, 32, 1, 16
    gen = torch.Generator(device=cuda).manual_seed(3)
    xbc = torch.randn((B, S, H * P + 2 * G * N + 5), generator=gen,
                      device=cuda).to(bf16)
    x = xbc[..., :H * P].reshape(B, S, H, P)
    Bm = xbc[..., H * P:H * P + G * N].reshape(B, S, G, N)
    Cm = xbc[..., H * P + G * N:H * P + 2 * G * N].reshape(B, S, G, N)
    assert not x.is_contiguous()
    dt = torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen,
                                                  device=cuda))
    A = -torch.rand((H,), generator=gen, device=cuda) - 0.5
    D = torch.ones((H,), device=cuda)
    y, h = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=64)
    y_ref, h_ref = ssd_chunked(x.contiguous(), dt, A, Bm.contiguous(),
                               Cm.contiguous(), D, chunk=64)
    tol = 3e-2 * float(y_ref.float().abs().max())
    torch.testing.assert_close(y.float(), y_ref.float(), atol=tol, rtol=0)
    torch.testing.assert_close(h, h_ref, rtol=0,
                               atol=SSD_STATE_TOL * float(h_ref.abs().max()))


def test_ssd_kernel_refuses_what_it_cannot_do(cuda):
    """A seq that is no multiple of the chunk, and a dtype the kernel does
    not take, raise on the card: nothing falls back to the plain version."""
    x, dt, A, Bm, Cm, D = _ssd_inputs((1, 96, 2, 16, 1, 8, 32, f32), cuda)
    before = ssd_ops.launches
    with pytest.raises(ValueError, match="divisible"):
        ssd_ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=64)
    half = torch.float16
    with pytest.raises(TypeError, match="dtype"):
        ssd_ops.ssd_scan(x.to(half), dt, A, Bm.to(half), Cm.to(half), D,
                         chunk=32)
    with pytest.raises(TypeError, match="float32"):
        ssd_ops.ssd_scan(x, dt.to(bf16), A, Bm, Cm, D, chunk=32)
    with pytest.raises(ValueError, match="chunk"):
        xl, dtl, Al, Bl, Cl, Dl = _ssd_inputs((1, 256, 2, 16, 1, 8, 256, f32),
                                              cuda)
        ssd_ops.ssd_scan(xl, dtl, Al, Bl, Cl, Dl, chunk=256)
    assert ssd_ops.launches == before


def test_reduced_mamba2_serve_goes_through_the_ssd_kernel(cuda):
    """The static-batch serve path on the card launches the SSD kernel once
    per layer per admission (the requests plus the warm-up's one)."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.serve import serve_benchmark
    from repro_torch.models import build_model

    cfg = get_reduced("mamba2_780m")
    before = ssd_ops.launches
    res = serve_benchmark(build_model(cfg), batch=2, prompt_len=24, gen=4,
                          device=cuda, log=lambda m: None)
    assert ssd_ops.launches - before == cfg.n_layers * (2 + 1)
    assert all(len(ids) == 4 and all(0 <= t < cfg.vocab for t in ids)
               for ids in res["generated_ids"])


def _hybrid(cuda, **kw):
    """Reduced Zamba2 at dh 80 through the flash kernel, seeded params."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model

    cfg = get_reduced("zamba2_2p7b").with_(head_dim=80, use_flash_kernel=True,
                                           **kw)
    params = build_model(cfg).init(torch.Generator(device=cuda).manual_seed(0))
    return cfg, params


def test_hybrid_prefill_through_both_kernels_matches_plain(cuda):
    """Reduced Zamba2 at dh 80: the prefill launches flash_fwd once per use
    of the shared block and ssd_scan once per Mamba2 layer, and its logits
    match the plain path's (plain attention, ``ssd_chunked``) within the
    bf16 logit bound of the CPU parity tests, 3e-2."""
    from unittest import mock

    import repro_torch.models.ssm as ssm
    from repro_torch.models import build_model

    cfg, params = _hybrid(cuda)
    tokens = torch.randint(3, cfg.vocab, (1, 64), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(1))
    f0, s0 = ops.launches, ssd_ops.launches
    kern, _ = build_model(cfg).prefill(params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert (ops.launches - f0, ssd_ops.launches - s0) == (2, 2)
    with mock.patch.object(ssm, "ssd_scan", lambda *a, chunk: ssd_chunked(
            *a, chunk=chunk)):
        plain, _ = build_model(cfg.with_(use_flash_kernel=False)).prefill(
            params, {"tokens": tokens})
    torch.testing.assert_close(kern.float(), plain.float(), atol=3e-2, rtol=0)


def test_hybrid_train_step_goes_through_both_kernels(cuda):
    """One reduced Zamba2 train step (dh 80, remat full): each kernel runs
    forward and in the remat recompute, the shared block's twice a use;
    every leaf's gradient is finite and non-zero."""
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves

    cs = _chip_smoke()
    cfg, params = _hybrid(cuda, remat="full")
    f0, s0 = ops.launches, ssd_ops.launches
    loss, grads = cs.step_grads(build_model(cfg), params,
                                _train_batch(cfg.vocab, cuda))
    assert (ops.launches - f0, ssd_ops.launches - s0) == (2 * 2, 2 * 2)
    assert loss == loss
    for g in tree_leaves(grads):
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


# ---------------------------------------------------------------------------
# training through the kernels (their autograd Functions)
# ---------------------------------------------------------------------------
def test_dh160_kernel_gradients_match_plain(cuda):
    """The wrapper's backward at dh 160 (GQA, causal, f32): the gradients
    through the kernel's ``autograd.Function`` against autograd of the
    plain version, within the JAX kernel test's 2e-4."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    ins = [torch.randn(shape, generator=gen, device=cuda)
           for shape in ((1, 160, 4, 160), (1, 160, 2, 160), (1, 160, 2, 160))]
    a = [t.clone().requires_grad_(True) for t in ins]
    b = [t.clone().requires_grad_(True) for t in ins]
    before = ops.launches
    got = torch.autograd.grad(torch.sum(ops.flash_attention(*a) ** 2), a)
    assert ops.launches == before + 1
    want = torch.autograd.grad(torch.sum(attention_ref(*b) ** 2), b)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=2e-4, rtol=0)


@pytest.mark.parametrize("T", [8, 1024], ids=["gathered", "grouped"])
def test_moe_main_path_on_the_card_matches_moe_dense(T, cuda):
    """DeepSeekMoE-16B's routed experts at full width (64 of width 1408,
    top 6, d_model 2048) on the card: the main path against the plain
    ``moe_dense`` on the same routing, 8 tokens (a decode tick: the
    per-assignment gather) and 1024 (a prefill: grouped by expert).  f32
    within 1e-5 of the largest element (sums of other orders); bf16 within
    one bf16 step of it, 2**-7."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as MOE

    cfg = get_config("deepseek_moe_16b")
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = {k: v for k, v in MOE.init_moe(cfg, gen).items() if k != "shared"}
    x32 = torch.randn((T, cfg.d_model), generator=gen, device=cuda)
    for dt, rel in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -7)):
        x = x32.to(dt)
        idx, gate, _ = MOE.route(cfg, p["router"], x)
        want = MOE.moe_dense(cfg, p, x, idx, gate)
        got = MOE.moe_routed(cfg, p, x, idx, gate)
        assert got.dtype == dt and got.shape == want.shape
        scale = float(want.float().abs().max())
        torch.testing.assert_close(got.float(), want.float(), atol=rel * scale,
                                   rtol=0)


def _chip_smoke():
    """``chip_smoke.py`` at the repo root: its train-step tolerances."""
    import importlib
    import os
    import sys

    root = os.path.join(os.path.dirname(__file__), "..")
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


def _train_batch(vocab, device, B=2, S=64):
    gen = torch.Generator(device=device).manual_seed(1)
    toks = torch.randint(3, vocab, (B, S), generator=gen, device=device)
    return {"tokens": toks, "labels": torch.roll(toks, -1, 1)}


@pytest.mark.parametrize("arch", ["qwen1p5_0p5b", "mamba2_780m"])
def test_train_step_through_the_kernel_matches_plain(arch, cuda):
    """One reduced train step through the kernel against the plain path,
    within chip_smoke.py's tolerances; the kernel ran forward and in the
    remat recompute of every layer; every leaf's gradient is non-zero."""
    from unittest import mock

    import repro_torch.models.ssm as ssm
    from repro_torch.configs import get_reduced
    from repro_torch.kernels.ssd.ref import ssd_chunked
    from repro_torch.models import build_model

    cs = _chip_smoke()
    qwen = arch.startswith("qwen")
    cfg = get_reduced(arch).with_(use_flash_kernel=qwen, remat="full")
    params = build_model(cfg).init(torch.Generator(device=cuda).manual_seed(0))
    batch = _train_batch(cfg.vocab, cuda)
    counter = ops if qwen else ssd_ops
    before = counter.launches
    kernel = cs.step_grads(build_model(cfg), params, batch)
    assert counter.launches - before == cfg.n_layers * 2
    if qwen:
        plain = cs.step_grads(build_model(cfg.with_(use_flash_kernel=False)),
                              params, batch)
    else:
        with mock.patch.object(ssm, "ssd_scan", lambda *a, chunk: ssd_chunked(
                *a, chunk=chunk)):
            plain = cs.step_grads(build_model(cfg), params, batch)
    dloss, rel, worst = cs.grad_diff(plain, kernel)
    loss_tol, grad_tol = cs.TRAIN_SLICES[
        "qwen" if qwen else "mamba2"]["tols"]["bfloat16"]
    assert dloss <= loss_tol
    assert rel[worst] <= grad_tol, (worst, rel[worst])
    from repro_torch.tree import tree_leaves

    for g in tree_leaves(kernel[1]):
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0


def test_kernel_paths_give_attention_and_ssm_gradients(cuda):
    """The gradients that a wrapper without a backward would lose: q/k/v
    projections through the flash kernel, in_proj and A_log through the
    SSD kernel."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model

    cs = _chip_smoke()
    for arch, leaves in (("qwen1p5_0p5b", ("wq", "wk", "wv")),
                         ("mamba2_780m", ("in_proj", "A_log"))):
        cfg = get_reduced(arch).with_(use_flash_kernel=True)
        model = build_model(cfg)
        params = model.init(torch.Generator(device=cuda).manual_seed(0))
        _, grads = cs.step_grads(model, params, _train_batch(cfg.vocab, cuda))
        block = grads["blocks"]["attn"] if arch.startswith("qwen") \
            else grads["ssm_blocks"]["ssm"]
        for name in leaves:
            assert float(block[name].abs().max()) > 0, (arch, name)


# ---------------------------------------------------------------------------
# the paged engine and its sampling head on the card
# ---------------------------------------------------------------------------
def test_paged_sampled_engine_on_the_card_matches_solo(cuda):
    """Reduced Qwen's paged engine on the card, a prefix-heavy trace of
    sampled and greedy requests over 2 slots: every request completes,
    later prefixes hit the radix cache, each stream equals the request run
    alone in a fresh engine of the same pool shape, and a prefix cache off
    changes no stream (``==``: the determinism contract on the card)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine, load_params
    from repro_torch.serve.workload import shared_prefix_trace

    model = build_model(get_reduced("qwen1p5_0p5b"))
    params = load_params(model, seed=0, device=cuda)
    trace = shared_prefix_trace(6, model.cfg.vocab, prefix_len=16, seed=7,
                                prompt_lens=(4, 8), gen_tokens=(6,),
                                temperature=0.7, top_k=12, top_p=0.9,
                                max_len=48)
    trace[1].temperature = 0.0
    kw = dict(n_slots=2, max_len=48, block_len=8, prefill_chunk=8)
    res = ServeEngine(model, params, **kw).run(trace, realtime=False)
    assert res["completed"] == 6 and res["prefill_cache_hit_rate"] > 0
    streams = [r["gen_ids"] for r in res["requests"]]
    assert all(0 <= t < model.cfg.vocab for s in streams for t in s)
    solo = ServeEngine(model, params, **kw)
    for r, s in zip(trace, streams):
        assert solo.run([r], realtime=False)["requests"][0]["gen_ids"] == s
    off = ServeEngine(model, params, prefix_cache=False, **kw).run(
        trace, realtime=False)
    assert [r["gen_ids"] for r in off["requests"]] == streams


def test_threefry_noise_on_the_card_is_the_cpus(cuda):
    from repro_torch.serve import prng
    from repro_torch.serve.sampling import request_key, token_key

    keys = torch.stack([token_key(request_key(s), s) for s in range(8)])
    V = 151936
    bits = prng.random_bits32(keys.to(cuda), V).cpu()
    assert torch.equal(bits, prng.random_bits32(keys, V))
    u = prng.uniform(keys.to(cuda), V, torch.finfo(torch.float32).tiny).cpu()
    assert torch.equal(u, prng.uniform(keys, V,
                                       torch.finfo(torch.float32).tiny))


# ---------------------------------------------------------------------------
# checkpoints on the card
# ---------------------------------------------------------------------------
def _card_train_state(cuda, param_dtype=None):
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import steps as ST

    model = build_model(get_reduced("qwen1p5_0p5b"))
    opt = AdamW(lr=1e-3)
    gen = torch.Generator(device=cuda).manual_seed(0)
    return model, opt, ST.init_train_state(model, opt, gen,
                                           param_dtype=param_dtype)


def _assert_equal_trees(a, b):
    from repro_torch.ckpt.format import flatten_with_paths

    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.device == y.device, k
        assert torch.equal(x, y), k


def test_async_snapshot_is_not_overwritten_by_the_in_place_step(cuda, tmp_path):
    """The optimizer writes the state in place: a save at step k, followed
    at once by more steps, must restore to the state after step k (``==``),
    not to a later one."""
    from repro_torch.ckpt import AsyncCheckpointer
    from repro_torch.train import steps as ST
    from repro_torch.tree import tree_map

    model, opt, state = _card_train_state(cuda)
    step = ST.make_train_step(model, opt)
    gen = torch.Generator(device=cuda).manual_seed(1)

    def batch():
        toks = torch.randint(3, model.cfg.vocab, (4, 128), generator=gen,
                             device=cuda, dtype=torch.int32)
        return {"tokens": toks, "labels": toks.roll(-1, 1)}

    for _ in range(2):
        state, _ = step(state, batch())
    after_k = tree_map(torch.clone, state)     # queued on the stream: no sync
    ck = AsyncCheckpointer(str(tmp_path / "ck"))
    ck.save(state, 2)
    for _ in range(3):                          # no sync before these
        state, _ = step(state, batch())
    ck.close()
    assert int(state["step"]) == 5
    restored = ck.restore(tree_map(torch.zeros_like, state), device=cuda)
    _assert_equal_trees(restored, after_k)
    assert not torch.equal(restored["params"]["embed"],
                           state["params"]["embed"])


def test_bf16_train_state_roundtrips_through_the_async_engine(cuda, tmp_path):
    from repro_torch.ckpt import AsyncCheckpointer, read_manifest
    from repro_torch.tree import tree_map

    _, _, state = _card_train_state(cuda, param_dtype=torch.bfloat16)
    assert state["params"]["embed"].dtype == torch.bfloat16
    ck = AsyncCheckpointer(str(tmp_path / "ck"))
    ck.save(state, 1)
    ck.close()
    man = read_manifest(ck.latest()[1])
    assert man["leaves"]["params/embed"]["dtype"] == "bfloat16"
    restored = ck.restore(tree_map(torch.empty_like, state), device=cuda)
    _assert_equal_trees(restored, state)


# ---------------------------------------------------------------------------
# resilience on the card
# ---------------------------------------------------------------------------
def test_nan_params_rollback_through_flash_matches_clean(cuda, tmp_path):
    """Reduced Qwen through ``flash_fwd`` on the run API: ``nan_params`` at
    step 5 corrupts the state on the card, the sentinel trips one window
    later, the gym rolls back to the step-4 checkpoint and replays; the
    curve ``==`` the clean run's, and the kernel launched for every
    dispatched step (8 = 6 + the replayed 5 and 6)."""
    import os

    from repro_torch.config.resolver import load_yaml
    from repro_torch.run import api
    from repro_torch.run.overrides import apply_overrides, parse_overrides

    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "configs", "quickstart.yaml")

    def run(name, *sets):
        doc = apply_overrides(load_yaml(path), parse_overrides(
            [f"dataset.config.prefix={tmp_path / 'qs'}",
             f"run.output_dir={tmp_path / name}", "run.train.steps=6",
             "gym.config.ckpt_every=2", "arch.config.use_flash_kernel=true",
             *sets]))
        before = ops.launches
        res = api.execute_doc(doc, device=cuda, log=lambda m: None)
        return res, ops.launches - before

    clean, n_clean = run("clean")
    chaos, n_chaos = run("chaos", "run.train.resilience={sentinel: true, "
                                  "faults: [{kind: nan_params, at: 5}]}")
    layers = 2 * 2          # reduced Qwen's attention layers x (fwd + remat)
    assert n_clean == layers * 6 and clean["steps_dispatched"] == 6
    assert chaos["steps_dispatched"] == 8 and n_chaos == layers * 8
    assert chaos["rollback_count"] == 1
    assert [(m["step"], m["loss"]) for m in chaos["history"]] == \
        [(m["step"], m["loss"]) for m in clean["history"]]


def test_snapshot_stays_finite_when_nan_params_follows_an_async_save(
        cuda, tmp_path):
    """``nan_params`` corrupts the params in place on the current stream
    right after an async save, with no synchronize between: stream order
    puts the save's copies first, so the checkpoint holds the clean step-2
    state (``==`` a clone queued before the corruption)."""
    from repro_torch.ckpt import AsyncCheckpointer
    from repro_torch.resilience import FaultInjector
    from repro_torch.train import steps as ST
    from repro_torch.tree import tree_leaves, tree_map

    model, opt, state = _card_train_state(cuda)
    step = ST.make_train_step(model, opt)
    gen = torch.Generator(device=cuda).manual_seed(2)
    for _ in range(2):
        toks = torch.randint(3, model.cfg.vocab, (4, 128), generator=gen,
                             device=cuda, dtype=torch.int32)
        state, _ = step(state, {"tokens": toks, "labels": toks.roll(-1, 1)})
    clean = tree_map(torch.clone, state)
    ck = AsyncCheckpointer(str(tmp_path / "ck"))
    ck.save(state, 2)
    state = FaultInjector.corrupt_params(state)     # no sync before it
    ck.close()
    assert all(bool(torch.isnan(p).all())
               for p in tree_leaves(state["params"]))
    restored = ck.restore(tree_map(torch.zeros_like, state), device=cuda)
    assert all(bool(torch.isfinite(p).all())
               for p in tree_leaves(restored["params"]))
    _assert_equal_trees(restored, clean)


def _card_lora(cuda):
    """Reduced Qwen through the flash kernel, wrapped in LoRA rank 4, with
    seeded params whose ``b`` factors are non-zero."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    from repro_torch.posttrain import lora as LO
    from repro_torch.tree import tree_map

    lm = LO.LoRAModel(build_model(get_reduced("qwen1p5_0p5b").with_(
        use_flash_kernel=True)), LO.LoRAConfig(rank=4))
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = lm.init(gen)
    params[LO.ADAPTER_KEY] = tree_map(
        lambda b: b + 0.02 * torch.randn(b.shape, generator=gen, device=cuda),
        params[LO.ADAPTER_KEY])
    return lm, params


def test_lora_merge_bitwise_through_flash(cuda):
    """The merged forward and the on-the-fly LoRA forward, both through
    ``flash_fwd`` in every layer, are ``==``; with TF32 switched on
    globally too (the merge computes its product in IEEE f32 whatever the
    flag says)."""
    lm, params = _card_lora(cuda)
    toks = torch.randint(3, lm.cfg.vocab, (2, 256), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            before = ops.launches
            with torch.no_grad():
                got, _ = lm.apply(params, {"tokens": toks})
                merged = lm.merge(params)
                want, _ = lm.base.apply(merged, {"tokens": toks})
            torch.cuda.synchronize()
            assert ops.launches == before + 2 * lm.cfg.n_layers
            assert torch.equal(got, want) and bool(torch.isfinite(got).all())
            wq = params["blocks"]["attn"]["wq"]
            ad = params["lora"]["blocks"]["attn"]["wq"]
            ref = wq.double() + lm.lora.scale * torch.einsum(
                "ldr,lrhk->ldhk", ad["a"].double(), ad["b"].double())
            # one f32 rounding of the sum (and of a rank-4 product) away
            # from the f64 merge: TF32 would be ~1e-3 of the product away
            assert float((merged["blocks"]["attn"]["wq"].double()
                          - ref).abs().max()) < 1e-6
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_dpo_first_loss_is_log2_and_reference_outlives_nan_params(cuda):
    """At init (b = 0) the policy and the zero-adapter reference compute one
    function through the flash kernel: loss ``log 2`` and margin 0.  The
    reference is a copy: after ``nan_params`` corrupts the policy in place,
    the reference's tensors are finite and share no storage with it."""
    import math

    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.posttrain import dpo as DPO
    from repro_torch.posttrain import lora as LO
    from repro_torch.resilience import FaultInjector
    from repro_torch.train import steps as ST
    from repro_torch.tree import tree_leaves, tree_map

    lm = LO.LoRAModel(build_model(get_reduced("qwen1p5_0p5b").with_(
        use_flash_kernel=True)), LO.LoRAConfig(rank=4))
    opt = LO.FrozenBaseOptimizer(AdamW(lr=1e-3, weight_decay=0.0))
    state = ST.init_train_state(
        lm, opt, torch.Generator(device=cuda).manual_seed(0))
    ref = tree_map(lambda x: x.detach().clone(),
                   LO.zero_adapters(state["params"]))
    ds = DPO.preference_synthetic_dataset(63, lm.cfg.vocab, n_pairs=8)
    batch = {k: torch.as_tensor(v, device=cuda)
             for k, v in ds.sample_batch(torch.arange(4).numpy()).items()}
    step = DPO.make_dpo_step(lm, opt, beta=0.1)
    before = ops.launches
    state, metrics = step(state, batch, ref)
    torch.cuda.synchronize()
    # policy 2 forwards x (forward + remat recompute), reference 2 forwards
    assert ops.launches == before + lm.cfg.n_layers * (2 * 2 + 2)
    assert abs(float(metrics["loss"]) - math.log(2)) <= 1e-6
    assert float(metrics["margin"]) == 0.0
    state = FaultInjector.corrupt_params(state)
    ptrs = {p.untyped_storage().data_ptr()
            for p in tree_leaves(state["params"])}
    assert all(bool(torch.isnan(p).all())
               for p in tree_leaves(state["params"]) if p.is_floating_point())
    for r in tree_leaves(ref):
        assert r.untyped_storage().data_ptr() not in ptrs
        assert bool(torch.isfinite(r).all())
    _, again = step(state, batch, ref)
    assert not math.isfinite(float(again["loss"]))


# ---------------------------------------------------------------------------
# DeepSeek-V3's MLA and MTP on the card (no kernel: einsums, as in JAX)
# ---------------------------------------------------------------------------
def _dsv3(cuda, **kw):
    """Reduced DeepSeek-V3 on the card with f32 activations, its seeded
    params."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model

    model = build_model(get_reduced("deepseek_v3_671b").with_(**kw))
    embed = model.embed_tokens
    model.embed_tokens = lambda p, t: embed(p, t, dtype=f32)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    return model, params


def _dsv3_decode(model, params, toks, cuda, paged=False):
    B, L = toks.shape
    kw = {}
    if paged:
        cache = model.init_paged_cache(B * L // 4, 4, dtype=f32, device=cuda)
        kw = {"pages": torch.arange(B * L // 4, dtype=torch.int32,
                                    device=cuda).flip(0).reshape(B, -1),
              "active": torch.ones(B, dtype=torch.bool, device=cuda)}
    else:
        cache = model.init_cache(B, L, dtype=f32, device=cuda)
    outs = []
    with torch.no_grad():
        for pos in range(L):
            lg, cache = model.decode_step(params, cache, toks[:, pos],
                                          torch.full((B,), pos, device=cuda),
                                          **kw)
            outs.append(lg)
    return torch.stack(outs, 1)


def _dsv3_tokens(cuda, L=20):
    return torch.randint(3, 512, (2, L), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))


def test_dsv3_decode_matches_forward_on_the_card(cuda):
    """Reduced DeepSeek-V3 in f32 on the card: token-by-token decode on the
    latent cache reproduces the forward's logits within JAX's 5e-4, and
    ``apply`` with labels carries a finite MTP loss."""
    model, params = _dsv3(cuda)
    toks = _dsv3_tokens(cuda)
    with torch.no_grad():
        full, aux = model.apply(params, {"tokens": toks,
                                         "labels": toks.roll(-1, 1)})
    assert torch.isfinite(aux["mtp"]) and float(aux["mtp"]) > 0
    err = float((full - _dsv3_decode(model, params, toks, cuda)).abs().max())
    assert err < 5e-4, err


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_dsv3_absorb_matches_expanded_on_the_card(paged, cuda):
    """The absorbed MLA decode against the expanded one, f32, dense and
    paged caches: within 5e-4, the decode-vs-forward bound."""
    toks = _dsv3_tokens(cuda, 16)
    runs = []
    for absorb in (False, True):
        model, params = _dsv3(cuda, mla_absorb=absorb)
        runs.append(_dsv3_decode(model, params, toks, cuda, paged))
    err = float((runs[0] - runs[1]).abs().max())
    assert err < 5e-4, err


def test_dsv3_paged_matches_dense_on_the_card(cuda):
    """The paged latent cache read through a reversed page table against
    the dense slot rows, f32: within 5e-4."""
    model, params = _dsv3(cuda)
    toks = _dsv3_tokens(cuda, 16)
    dense = _dsv3_decode(model, params, toks, cuda)
    paged = _dsv3_decode(model, params, toks, cuda, paged=True)
    assert float((dense - paged).abs().max()) < 5e-4


# ---------------------------------------------------------------------------
# the bench kind on the card
# ---------------------------------------------------------------------------
def test_bench_kind_on_the_card_goes_through_the_kernel(cuda, tmp_path,
                                                        monkeypatch):
    """``bench.yaml`` at reduced size with ``use_flash_kernel``: the card is
    synchronized after the first step, after the warm-up and at each
    window's end; every step launches ``flash_fwd`` in each attention layer
    forward and in the remat recompute; ``bench_dir: "."`` writes under the
    run's output_dir and leaves the working directory alone."""
    import os

    from repro_torch.config.resolver import load_yaml
    from repro_torch.run import api
    from repro_torch.run.overrides import apply_overrides, parse_overrides

    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "configs", "bench.yaml")
    doc = apply_overrides(load_yaml(path), parse_overrides(
        [f"dataset.config.prefix={tmp_path / 'bq'}",
         f"run.output_dir={tmp_path / 'run'}", "run.bench.steps=3",
         "run.bench.warmup=1", "run.bench.windows=3",
         "arch.config.use_flash_kernel=true"]))
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    syncs = []
    sync = torch.cuda.synchronize

    def counting(device=None):
        syncs.append(device)
        sync(device)

    monkeypatch.setattr(torch.cuda, "synchronize", counting)
    before = ops.launches
    res = api.execute_doc(doc, device=cuda, write_result=True,
                          log=lambda m: None)
    layers = 2 * 2          # reduced Qwen's attention layers x (fwd + remat)
    assert ops.launches - before == layers * (1 + 1 + 3)
    assert len(syncs) >= 1 + 1 + 3
    assert res["steady_step_ms"] > 0 and len(res["windows"]) == 3
    assert res["bench_file"] == str(tmp_path / "run" / "BENCH_quickstart.json")
    assert os.listdir(cwd) == []


def test_pipeline_tokens_train_one_step_through_the_kernel(cuda, tmp_path):
    """A JSONL corpus through the tokenizer pipeline (2 spawned workers, a
    parent holding a live CUDA context: ``spawn``, never ``fork``), the
    parallel files byte-equal to the serial baseline's, then one train
    step of reduced Qwen with ``use_flash_kernel`` on the written tokens
    (``dataset/packed_chunked``): the loss finite, ``flash_fwd`` launched
    in each attention layer's forward and remat recompute."""
    import json
    import math
    import os

    import numpy as np

    from repro_torch.config.resolver import load_yaml
    from repro_torch.data.tokenize_pipeline import (tokenize_file,
                                                    tokenize_file_serial)
    from repro_torch.data.tokenizer import ByteTokenizer
    from repro_torch.run import api
    from repro_torch.run.overrides import apply_overrides, parse_overrides

    torch.zeros(1, device=cuda)  # the CUDA context is live
    rng = np.random.default_rng(0)
    words = ["the", "quick", "brown", "fox", "jumps", "over", "lazy", "dog"]
    corpus = tmp_path / "corpus.jsonl"
    with open(corpus, "w") as f:
        for _ in range(400):
            f.write(json.dumps({"text": " ".join(
                rng.choice(words, int(rng.integers(10, 60))))}) + "\n")
    par = tokenize_file(str(corpus), str(tmp_path / "par"), ByteTokenizer(),
                        n_workers=2, batch_docs=32)
    ser = tokenize_file_serial(str(corpus), str(tmp_path / "ser"),
                               ByteTokenizer())
    for key in ("tokens_path", "docidx_path"):
        with open(par[key], "rb") as a, open(ser[key], "rb") as b:
            assert a.read() == b.read()
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "configs", "quickstart.yaml")
    doc = apply_overrides(load_yaml(path), parse_overrides(
        ["dataset.variant_key=packed_chunked",
         f"dataset.config={{prefix: {tmp_path / 'par'}, seq_len: 64}}",
         "run.train.steps=1", "run.train.telemetry=false",
         "arch.config.use_flash_kernel=true"]))
    before = ops.launches
    res = api.execute_doc(doc, device=cuda, log=lambda m: None)
    assert math.isfinite(res["final_loss"])
    assert ops.launches - before == 2 * 2  # 2 layers x (fwd + remat)


# ---------------------------------------------------------------------------
# a sharding plan on the card (one-rank NCCL group)
# ---------------------------------------------------------------------------
def test_fsdp_tp_step_through_flash_equals_the_no_mesh_step(cuda):
    """One ``fsdp_tp`` train step of reduced Qwen through ``flash_fwd`` on a
    ``(1, 1)`` mesh over a one-rank NCCL group: the kernel runs on the
    local blocks (2 layers x (forward + remat recompute) launches), the
    params and moments are DTensors, and the loss and every updated param
    ``==`` the step with no mesh."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import mesh as MESH
    from repro_torch.sharding import plans as PL
    from repro_torch.train import steps as ST
    from repro_torch.tree import tree_leaves, tree_map

    model, opt, state = _card_train_state(cuda)
    model = type(model)(model.cfg.with_(use_flash_kernel=True))
    gen = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(3, model.cfg.vocab, (4, 128), generator=gen,
                         device=cuda, dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    plain = tree_map(torch.clone, state)
    _, want = ST.make_train_step(model, opt)(plain, batch)
    try:
        mesh = MESH.make_local_mesh(1, 1, device_type="cuda")
        plan = PL.make_plan("fsdp_tp")
        sh, _ = PL.train_state_shardings(plan, mesh, model, opt)
        sharded = PL.distribute(state, sh)
        step = ST.make_train_step(model, opt, PL.mesh_context(plan, mesh))
        before = ops.launches
        _, got = step(sharded, PL.distribute(
            batch, PL.batch_shardings(plan, mesh, batch)))
        assert ops.launches - before == 2 * 2
        assert torch.equal(got["loss"], want["loss"])
        leaves = tree_leaves(sharded["params"]) + tree_leaves(
            sharded["opt"]["m"])
        assert all(isinstance(t, DTensor) for t in leaves)
        for a, b in zip(tree_leaves(sharded["params"]),
                        tree_leaves(plain["params"])):
            assert torch.equal(a.full_tensor(), b)
    finally:
        MESH.shutdown()


def test_stage_local_pipelined_step_through_flash_equals_the_step(cuda):
    """One train step of reduced Qwen (2 layers) through ``flash_fwd`` with
    the pipelined backbone stage-local (``pp`` 2, 4 microbatches, no pipe
    group) against the unpipelined step: the kernel launches 2 layers x 4
    microbatches x 2 (forward and remat recompute) times, each at a
    quarter of the batch, and the loss and every gradient are within
    ``chip_smoke.py``'s bf16 bounds for full-width Qwen (1e-3 on the loss,
    0.06 of each leaf's largest gradient)."""
    from repro_torch.models import base as B
    from repro_torch.tree import tree_leaves

    model, _, state = _card_train_state(cuda)
    model = type(model)(model.cfg.with_(use_flash_kernel=True))
    gen = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(3, model.cfg.vocab, (8, 128), generator=gen,
                         device=cuda, dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    from repro_torch.train import steps as ST

    def grads(ctx):
        return ST.value_and_grad(
            lambda p, b: ST.compute_loss(model, p, b, ctx), state["params"],
            batch)

    want_aux, want = grads(None)
    before = ops.launches
    got_aux, got = grads(B.MeshContext(pp=2, n_micro=4))
    assert ops.launches - before == model.cfg.n_layers * 4 * 2
    assert abs(float(got_aux["ce"]) - float(want_aux["ce"])) <= 1e-3
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        scale = float(b.float().abs().max())
        assert float((a.float() - b.float()).abs().max()) <= 0.06 * scale


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen1p5_0p5b", "mamba2_780m"])
def test_card_step_counts_what_its_dryrun_counts(cuda, arch):
    """One reduced train step on the card under the dryrun's counter (a
    ``(1, 1)`` mesh over a one-rank NCCL group, ``ddp``), through
    ``flash_fwd`` or ``ssd_scan``: its FLOPs, bytes, collectives and
    argument bytes ``==`` the dryrun of the same step on a fake world, and
    the kernel launches once a layer, forward and remat recompute."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch.hlo_analysis import CostCounter
    from repro_torch.models import build_model
    from repro_torch.sharding import plans as PL

    cfg = get_reduced(arch).with_(use_flash_kernel=arch.startswith("qwen"))
    shape = InputShape("card", 128, 2, "train")
    plan = PL.make_plan("ddp")
    dry = DR.compile_run(cfg, shape, MESH.LocalMesh(1, 1), plan)
    counter = ops if cfg.use_flash_kernel else ssd_ops
    try:
        mesh = MESH.make_local_mesh(1, 1, device_type="cuda")
        setup = DR.build_step(build_model(cfg), shape, mesh, plan,
                              device=cuda)
        before = counter.launches
        with CostCounter(arguments=setup.args) as c:
            out = setup.fn(*setup.args)
            torch.cuda.synchronize()
        ana, mem = c.analyze(), c.memory(setup.args, out)
    finally:
        MESH.shutdown()
    assert counter.launches - before == 2 * cfg.n_layers
    assert ana["flops"] == dry["hlo_flops_per_dev"]
    assert ana["bytes"] == dry["hlo_bytes_per_dev"]
    assert ana["collective_counts"] == dry["collective_counts"]
    assert mem["mem_argument_size_in_bytes"] == \
        dry["mem_argument_size_in_bytes"]
    assert torch.isfinite(out[1]["loss"])


def test_hybrid_fsdp_tp_step_through_both_kernels_equals_the_no_mesh_step(
        cuda):
    """One ``fsdp_tp`` train step of reduced-depth Zamba2 (2 Mamba2 layers,
    each followed by a use of the shared block) through ``flash_fwd`` and
    ``ssd_scan`` on a ``(1, 1)`` mesh over a one-rank NCCL group: each
    kernel launches once a use or a Mamba2 layer, forward and remat
    recompute, on the local blocks, and the loss and every updated param
    ``==`` the step with no mesh."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch import mesh as MESH
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.sharding import plans as PL
    from repro_torch.train import steps as ST
    from repro_torch.tree import tree_leaves, tree_map

    model = build_model(get_reduced("zamba2_2p7b").with_(
        use_flash_kernel=True))
    opt = AdamW(lr=1e-3)
    state = ST.init_train_state(
        model, opt, torch.Generator(device=cuda).manual_seed(0))
    gen = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(3, model.cfg.vocab, (4, 128), generator=gen,
                         device=cuda, dtype=torch.int32)
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    plain = tree_map(torch.clone, state)
    _, want = ST.make_train_step(model, opt)(plain, batch)
    try:
        mesh = MESH.make_local_mesh(1, 1, device_type="cuda")
        plan = PL.make_plan("fsdp_tp")
        sh, _ = PL.train_state_shardings(plan, mesh, model, opt)
        sharded = PL.distribute(state, sh)
        step = ST.make_train_step(model, opt, PL.mesh_context(plan, mesh))
        before = (ops.launches, ssd_ops.launches)
        _, got = step(sharded, PL.distribute(
            batch, PL.batch_shardings(plan, mesh, batch)))
        assert (ops.launches - before[0], ssd_ops.launches - before[1]) == \
            (2 * 2, 2 * 2)
        assert torch.equal(got["loss"], want["loss"])
        for a, b in zip(tree_leaves(sharded["params"]),
                        tree_leaves(plain["params"])):
            assert torch.equal(a.full_tensor(), b)
    finally:
        MESH.shutdown()
