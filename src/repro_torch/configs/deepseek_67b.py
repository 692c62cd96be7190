"""deepseek-67b [dense] — 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400, llama-arch. [arXiv:2401.02954; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab_size=102400, head_dim=128, rope_theta=1e4,
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=3, d_model=96, n_heads=8, n_kv_heads=2, d_ff=192,
    vocab_size=256, head_dim=12)
