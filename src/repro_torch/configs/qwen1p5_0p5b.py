"""Qwen1.5-0.5B: QKV bias, tied embeddings. [hf:Qwen/Qwen1.5-0.5B]"""
from ..models.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b",
    arch_type="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab=151936,
    head_dim=64,
    qkv_bias=True,
    tie_embeddings=True,
    source="hf:Qwen/Qwen1.5-0.5B",
)
