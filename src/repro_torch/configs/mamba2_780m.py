"""Mamba2-780M: attention-free SSD. [arXiv:2405.21060]"""
from ..models.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    arch_type="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,           # attention-free
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    head_dim=64,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=128),
    source="arXiv:2405.21060",
)
