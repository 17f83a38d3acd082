"""DeepSeekMoE-16B: fine-grained experts, 2 shared + 64 routed top-6.
[arXiv:2401.06066]"""
from ..models.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    arch_type="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,           # routed-expert hidden (fine-grained)
    vocab=102400,
    head_dim=128,
    moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_expert=1408,
                  n_dense_layers=1),
    source="arXiv:2401.06066",
)
