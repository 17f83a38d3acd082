"""DeepSeek-V3-671B: MLA, 1 shared + 256 routed top-8, MTP.
[arXiv:2412.19437]"""
from ..models.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,           # routed-expert hidden
    vocab=129280,
    head_dim=192,        # nope 128 + rope 64
    moe=MoEConfig(n_routed=256, n_shared=1, top_k=8, d_expert=2048,
                  n_dense_layers=3),
    mla=MLAConfig(q_lora=1536, kv_lora=512, head_dim_nope=128,
                  head_dim_rope=64, head_dim_v=128),
    mtp=True,
    source="arXiv:2412.19437",
)
