"""Whisper-tiny backbone: enc-dec; mel/conv frontend is a STUB
(input_specs supplies frame embeddings). [arXiv:2212.04356]"""
from ..models.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    arch_type="audio",
    n_layers=4,           # decoder layers
    n_encoder_layers=4,
    encoder_frames=1500,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    head_dim=64,
    norm_type="layernorm",
    act="gelu",
    qkv_bias=True,
    max_positions=32768,
    source="arXiv:2212.04356",
)
