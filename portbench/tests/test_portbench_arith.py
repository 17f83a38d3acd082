"""The frozen arithmetic against the repo's own figures."""
import json
import os

import pytest

from conftest import ROOT
from portbench.reference import params
from portbench.work import flash, model_flops, peaks, ssd


def _config(name):
    with open(os.path.join(ROOT, "portbench", "configs", f"{name}.json")) as f:
        return json.load(f)


def test_flash_bound_is_the_kernel_tables():
    # 8.39 MB at B 1, S 1024, H 16, dh 64 (PERF.md's flash row 1)
    n_bytes, n_ops = flash.flash_work(1, 1024, 16, 16, 64)
    assert n_bytes == 8_388_608
    assert n_ops == 4 * 64 * (1024 * 1025 // 2) * 16
    assert peaks.bound_s(n_bytes, n_ops) == pytest.approx(0.00250e-3, rel=2e-3)


def test_ssd_work_is_the_kernel_tables():
    # 14.88 MB at Mamba2-780M's prefill of 1024 tokens (PERF.md's row 2)
    n_bytes, _ = ssd.ssd_work(1, 1024, 48, 64, 1, 128, 128, 2)
    assert n_bytes == 14_877_056
    assert peaks.bound_s(*ssd.ssd_work(1, 1024, 48, 64, 1, 128, 128, 2)) \
        == pytest.approx(0.00444e-3, rel=2e-3)


def test_peaks_are_the_ports():
    from repro_torch.device import HBM_BYTES_S, PEAK_FLOPS_BF16

    assert (peaks.PEAK_FLOPS_BF16, peaks.HBM_BYTES_S) == (PEAK_FLOPS_BF16,
                                                          HBM_BYTES_S)


def test_params_counted_once():
    from repro_torch.configs import get_config
    from repro_torch.device import MetaGenerator
    from repro_torch.models import build_model
    from repro_torch.telemetry.accounting import count_param_leaves

    config = _config("mamba2-780m")
    # the port's mamba2_780m (untied, vocab 50280) is 857,379,072; tied at
    # the published padded vocabulary of 50288 it is that less its head
    # (1536 x 50280) and plus 8 rows of the embedding
    n = 857_379_072 - 1536 * 50280 + 8 * 1536
    assert params.n_params(config["arch"]) == n == 780_161_280
    port = build_model(get_config("mamba2_780m").with_(**config["overrides"]))
    assert count_param_leaves(port.init(MetaGenerator())) == n
    assert count_param_leaves(build_model(get_config("mamba2_780m")).init(
        MetaGenerator())) == 857_379_072


def test_mamba2_has_no_attention_term():
    a = _config("mamba2-780m")["arch"]
    assert model_flops.flops_per_token(a, 2048) == 6 * 780_161_280
    assert model_flops.flops_per_step(a, 24, 2048) == \
        6 * 780_161_280 * 24 * 2048
