"""Shared pieces of the benchmark's CPU tests: the repo's ``src`` on the
path, a tiny cell, and the ``cuda`` fixture that
skips a card-marked test on a host without a card."""
from __future__ import annotations

import copy
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: a tiny Mamba2 (``custom`` in the port's registry), tied head as in the
#: benchmark's configuration
TINY_ARCH = {"arch_type": "ssm", "n_layers": 3, "d_model": 64, "n_heads": 0,
             "n_kv_heads": 0, "d_ff": 0, "vocab": 304, "head_dim": 16,
             "tie_embeddings": True, "norm_type": "rmsnorm",
             "norm_eps": 1e-5,
             "ssm": {"d_state": 32, "d_conv": 4, "expand": 2,
                     "head_dim": 16, "n_groups": 1, "chunk": 32}}

#: limits for the tiny cell on the CPU, set between the program's gaps on
#: seeds 1-5 (bf16 compute against the f32 reference: loss up to 3.6e-5,
#: the worst leaf's gradient norm up to 0.0054, its change up to 0.0057)
#: and the fp8 control's (loss from 1.3e-4, gradient from 0.0166, change
#: from 0.0131)
TINY_LIMITS = {"loss_gap": 8e-5, "grad_gap": 0.01, "change_gap": 0.009}


def tiny_cell():
    """A cell of the tiny architecture, with the benchmark's own optimizer
    and traffic cut to 4 rows of 64 tokens a step."""
    with open(os.path.join(ROOT, "portbench", "configs",
                           "mamba2-780m.json")) as f:
        base = json.load(f)
    with open(os.path.join(ROOT, "portbench", "traffic",
                           "tokens.24x2048.json")) as f:
        traffic = json.load(f)
    traffic.update(global_batch=4, seq_len=64, rows=64)
    config = {"name": "tiny-ssm", "port_key": "custom",
              "arch": copy.deepcopy(TINY_ARCH), "token_ids": 300,
              "settings": {"use_flash_kernel": False, "remat": "full",
                           "scan_block_size": 1},
              "optimizer": base["optimizer"],
              "reference": {"rows_per_block": 2}}
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    return {"name": "tiny-ssm", "chips": 1, "config": config,
            "traffic": traffic, "limits": dict(TINY_LIMITS),
            "end_to_end": bench["end_to_end"],
            "per_layer": bench["per_layer"]}


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
