"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
(expert) vocab=49155, 40 experts top-8. [hf:ibm-granite/...; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab_size=49155, head_dim=64, rope_theta=1e4, tie_embeddings=True,
    moe=MoEConfig(n_experts=40, top_k=8, d_expert=512, n_shared=0,
                  n_dense_layers=0, capacity_factor=1.25,
                  n_experts_padded=48),
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
    vocab_size=256, head_dim=16,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, n_shared=0,
                  n_dense_layers=0, capacity_factor=1.25),
)
