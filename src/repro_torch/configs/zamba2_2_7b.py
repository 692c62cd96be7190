"""zamba2-2.7b [hybrid] — 54 Mamba2 blocks d_model=2560, ssm_state=64,
ONE shared GQA block (32H kv=32) applied every 6 blocks on
concat(h, embedding). d_ff=10240 (shared block MLP). [arXiv:2411.15242; hf]"""
from repro_torch.configs.base import HybridConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab_size=32000, head_dim=80, rope_theta=1e4,
    sub_quadratic=True,
    ssm=SSMConfig(kind="mamba2", d_state=64, d_conv=4, expand=2,
                  head_dim=64, chunk=256),
    hybrid=HybridConfig(attn_every=6, n_shared_blocks=1,
                        concat_embedding=True),
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, head_dim=16,
    ssm=SSMConfig(kind="mamba2", d_state=16, d_conv=4, expand=2,
                  head_dim=32, chunk=64),
    hybrid=HybridConfig(attn_every=2, n_shared_blocks=1,
                        concat_embedding=True),
)
