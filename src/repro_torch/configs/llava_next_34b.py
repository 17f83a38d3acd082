"""LLaVA-NeXT-34B language backbone; anyres vision tiling is a STUB
(input_specs supplies patch embeddings). [hf:llava-hf/llava-v1.6]"""
from ..models.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    arch_type="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    head_dim=128,
    n_patches=576,       # anyres base-tile patch embeddings (stub frontend)
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
