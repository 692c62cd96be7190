"""Architecture configuration schema (dense GQA family).

A copy of the JAX package's ``ModelConfig`` for the family the PyTorch
port serves so far, the dense pre-norm GQA transformers, holding the
fields the port reads.  The MoE / MLA / SSM / enc-dec / hybrid
sub-configs and the W8A8 / attention-kernel selectors are not ported
yet.  Configs are frozen, hashable dataclasses.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense (the only family ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    act: str = "silu"              # silu (SwiGLU)
    tie_embeddings: bool = False
    attn_bias: bool = False
    dtype: str = "bfloat16"
    # int8 KV cache: Eq. 1 applied to the cache with a static fractional
    # bit (post-rope/qk-norm K and V are O(1)-ranged; n=4 keeps |x|<8).
    kv_cache_bits: Optional[int] = None
    kv_cache_frac_bits: int = 4

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Embedding/head tables padded to a multiple of 128."""
        return -(-self.vocab_size // 128) * 128

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced-config variant for CPU smoke tests."""
        return dataclasses.replace(self, **kw)
