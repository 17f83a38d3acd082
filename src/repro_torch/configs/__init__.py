"""Architecture configs: one module per assigned arch (+ the paper's own
LLaMA-3-8B benchmark model). ``get_config(name)`` returns the full config,
``get_reduced(name)`` the smoke-test variant (2 layers, d_model<=512,
<=4 experts).

The port's own copy of ``repro.configs``: the same table, the same
reduction rule, field for field (``tests/test_torch_config.py`` holds the
two equal).
"""
from __future__ import annotations

import dataclasses
import importlib

from ..models.base import ArchConfig, MLAConfig, MoEConfig, SSMConfig  # noqa: F401
from .shapes import SHAPES, InputShape  # noqa: F401

ARCH_IDS = [
    "deepseek_moe_16b",
    "zamba2_2p7b",
    "llava_next_34b",
    "granite_34b",
    "stablelm_12b",
    "whisper_tiny",
    "stablelm_1p6b",
    "mamba2_780m",
    "qwen1p5_0p5b",
    "deepseek_v3_671b",
]

_ALIASES = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "zamba2-2.7b": "zamba2_2p7b",
    "llava-next-34b": "llava_next_34b",
    "granite-34b": "granite_34b",
    "stablelm-12b": "stablelm_12b",
    "whisper-tiny": "whisper_tiny",
    "stablelm-1.6b": "stablelm_1p6b",
    "mamba2-780m": "mamba2_780m",
    "qwen1.5-0.5b": "qwen1p5_0p5b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "llama3-8b": "llama3_8b",
}


def canonical(name: str) -> str:
    return _ALIASES.get(name, name.replace("-", "_").replace(".", "p"))


def get_config(name: str) -> ArchConfig:
    mod = importlib.import_module(f".{canonical(name)}", __package__)
    return mod.CONFIG


def get_reduced(name: str) -> ArchConfig:
    return reduce_config(get_config(name))


def reduce_config(cfg: ArchConfig) -> ArchConfig:
    """Same family, smoke-test scale: 2 layers, d_model<=512, <=4 experts."""
    kw = dict(
        name=cfg.name + "-reduced",
        n_layers=2,
        d_model=256,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_ff=512 if cfg.d_ff else 0,
        vocab=512,
        head_dim=64,
        scan_block_size=1,
    )
    if cfg.moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            n_routed=4,
            top_k=2,
            d_expert=128,
            n_dense_layers=min(cfg.moe.n_dense_layers, 1),
        )
    if cfg.mla:
        kw["mla"] = MLAConfig(
            q_lora=96, kv_lora=64, head_dim_nope=32, head_dim_rope=16, head_dim_v=32
        )
        kw["head_dim"] = 48
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=32, chunk=32
        )
    if cfg.arch_type == "hybrid":
        kw["n_layers"] = 4
        kw["attn_every"] = 2
    if cfg.n_encoder_layers:
        kw["n_encoder_layers"] = 2
        kw["encoder_frames"] = 64
    if cfg.n_patches:
        kw["n_patches"] = 16
    return cfg.with_(**kw)
