"""LLaMA-3-8B: the paper's own Fig-2 benchmark model."""
from ..models.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-8b",
    arch_type="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    head_dim=128,
    rope_theta=500000.0,
    source="paper Fig. 2 (Meta LLaMA-3-8B)",
)
