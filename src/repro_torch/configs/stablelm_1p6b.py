"""StableLM-2-1.6B. [hf:stabilityai/stablelm-2-1_6b]"""
from ..models.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-1.6b",
    arch_type="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab=100352,
    head_dim=64,
    source="hf:stabilityai/stablelm-2-1_6b",
)
