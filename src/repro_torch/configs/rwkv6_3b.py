"""rwkv6-3b "Finch" [ssm] — 32L d_model=2560 (attn-free) d_ff=8960
vocab=65536, data-dependent decay. [arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=8960,
    vocab_size=65536, head_dim=64, act="relu_sq",
    sub_quadratic=True,
    # chunk 32: the chunked linear-attention form exponentiates the within-
    # chunk cumulative log-decay; with the per-token decay floor exp(-1.65)
    # this keeps every exp() < e^53 (finite in fp32).  See models/rwkv.py.
    ssm=SSMConfig(kind="rwkv6", chunk=32),
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, d_ff=256,
    vocab_size=256, head_dim=64)
