"""deepseek-v3-671b [moe] — 61L d_model=7168 128H d_ff=2048(expert)
vocab=129280, MLA, 1 shared + 256 routed top-8. [arXiv:2412.19437; hf]

The first 3 layers are dense (SwiGLU at d_ff 18432); MLA makes
n_kv_heads nominal (the cache holds the 512-wide latent and the shared
64-wide rope key).  The MTP head is omitted, as in the reference."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432,  # dense-layer FFN width (first 3 layers)
    vocab_size=129280, head_dim=128, rope_theta=1e4,
    moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
                  n_dense_layers=3, capacity_factor=1.25),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=192,
    vocab_size=256, head_dim=16,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=48, n_shared=1,
                  n_dense_layers=1, capacity_factor=1.25),
    mla=MLAConfig(q_lora_rank=48, kv_lora_rank=32, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16),
)
