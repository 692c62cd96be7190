"""Architecture configuration schema.

A copy of the JAX package's ``ModelConfig`` for the families the PyTorch
port serves, holding the fields the port reads: the dense pre-norm GQA
transformers (families ``dense`` and ``vlm``), the recurrent (``ssm``:
RWKV6) and hybrid (Mamba2 groups plus one shared attention block)
families with their ``SSMConfig`` / ``HybridConfig``, and the routed
mixture of experts (``moe``) with its ``MoEConfig`` and, for DeepSeek's
latent attention, ``MLAConfig``, and the audio encoder-decoder
(``audio``: whisper) with its ``EncDecConfig``.  Configs are frozen,
hashable dataclasses.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["MoEConfig", "MLAConfig", "SSMConfig", "EncDecConfig",
           "HybridConfig", "ModelConfig", "ShapeConfig", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                  # per-expert FFN hidden size
    n_shared: int = 0              # always-on shared experts (DeepSeek-V3)
    n_dense_layers: int = 0        # leading layers that stay dense
    capacity_factor: float = 1.25
    router_dtype: str = "float32"  # router math stays high precision
    # the expert STACKS (not the router) padded to this many experts (the
    # reference pads granite's 40 to 48 for its expert-parallel axis);
    # the padding experts receive no tokens
    n_experts_padded: Optional[int] = None
    # a mesh rank's view (``distributed.sharding.local_config``): the
    # expert stacks cut over this many model ranks, each expert's hidden
    # over this many data ranks (serving's 2-D rule); 1 off a mesh.  The
    # fields above stay the whole model's (the router, the capacity)
    expert_shards: int = 1
    hidden_shards: int = 1

    @property
    def e_padded(self) -> int:
        return self.n_experts_padded or self.n_experts

    @property
    def e_local(self) -> int:
        """Experts a rank holds."""
        return self.e_padded // self.expert_shards

    @property
    def d_expert_local(self) -> int:
        """An expert's hidden width a rank holds."""
        return self.d_expert // self.hidden_shards


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek Multi-head Latent Attention dims (arXiv:2412.19437)."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / RWKV6 recurrence dims."""

    kind: str = "mamba2"           # 'mamba2' | 'rwkv6'
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256               # SSD / chunked-linear-attention chunk len
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_encoder_layers: int
    encoder_seq: int = 1500        # whisper: 30 s of audio at 50 Hz post-conv
    frontend: str = "stub"         # modality frontend is a stub per assignment


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: shared attention block every ``attn_every`` SSM blocks."""

    attn_every: int = 6
    n_shared_blocks: int = 1
    concat_embedding: bool = True  # shared block sees concat(h, h_embed)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | vlm | moe | audio | ssm | hybrid
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
    act: str = "silu"              # silu (SwiGLU) | gelu | relu_sq (rwkv)
    tie_embeddings: bool = False
    attn_bias: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    encdec: Optional[EncDecConfig] = None
    hybrid: Optional[HybridConfig] = None
    dtype: str = "bfloat16"
    # which shapes this arch supports (long_500k only for sub-quadratic)
    sub_quadratic: bool = False
    # int8 KV cache: Eq. 1 applied to the cache with a static fractional
    # bit (post-rope/qk-norm K and V are O(1)-ranged; n=4 keeps |x|<8).
    kv_cache_bits: Optional[int] = None
    kv_cache_frac_bits: int = 4
    # int8 recurrent-state slabs: Eq. 1 applied to the RWKV / Mamba
    # sequence state on the fixed-slab substrate, the whole slab
    # requantized once per engine step on a per-slab po2 grid (the decay
    # math stays fp32).  None keeps fp32 slabs.
    state_bits: Optional[int] = None
    state_frac_bits: int = 4
    # attention of the dense-cache paths (forward, prefill, decode_step):
    #   'chunked' — the plain PyTorch versions of the flash kernels
    #   'flash'   — K5 / K6 (``kernels.ops.flash_attention`` /
    #               ``flash_decode``); int8 KV codes are dequantized in
    #               registers.  The ragged serving path ignores it.
    attn_kernel: str = "chunked"
    # mesh axis the attention heads are cut over (whole GQA groups, their
    # KV heads and cache with them, ``distributed.sharding``); only
    # 'model' is wired (``launch.steps`` refuses any other on a mesh of
    # more than one rank), and its size must divide n_kv_heads
    attn_shard_axis: str = "model"
    # projection matmuls: 'dense' follows the QuantContext mode; 'int8' is
    # the W8A8 deploy (weights pre-quantized by ``quantize_params``),
    # which requires a calibrated INT-mode context (checked when a step
    # is built, ``launch.steps``)
    matmul_kernel: str = "dense"

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


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One workload shape of the reference's cells: ``kind`` 'train',
    'prefill' or 'decode', ``global_batch`` sequences of ``seq_len``."""
    name: str
    seq_len: int
    global_batch: int
    kind: str


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
