"""whisper-large-v3 [audio] — enc-dec, 32L decoder d_model=1280 20H
d_ff=5120 vocab=51866; conv frontend STUBBED (the prompt carries
precomputed frame embeddings). [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120,
    vocab_size=51866, head_dim=64, act="gelu", attn_bias=True,
    encdec=EncDecConfig(n_encoder_layers=32, encoder_seq=1500),
)

SMOKE_CONFIG = CONFIG.scaled(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=256, head_dim=16,
    encdec=EncDecConfig(n_encoder_layers=2, encoder_seq=64),
)
