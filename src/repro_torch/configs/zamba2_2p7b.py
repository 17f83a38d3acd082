"""Zamba2-2.7B: Mamba2 backbone + weight-shared attention block every 6th
layer. [arXiv:2411.15242]"""
from ..models.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    arch_type="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,          # shared attention block MLP
    vocab=32000,
    head_dim=80,
    attn_every=6,        # 45 mamba2 + 9 (weight-shared) attention blocks
    shared_attn_block=True,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=128),
    source="arXiv:2411.15242",
)
