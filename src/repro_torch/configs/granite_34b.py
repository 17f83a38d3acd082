"""Granite-34B-Code: llama-arch with MQA (kv=1). [arXiv:2405.04324]"""
from ..models.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    arch_type="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,        # MQA — KV projections replicated under TP
    d_ff=24576,
    vocab=49152,
    head_dim=128,
    source="arXiv:2405.04324",
)
