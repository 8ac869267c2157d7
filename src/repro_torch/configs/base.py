"""Architecture configuration schema + input-shape definitions.

A copy of ``repro.configs.base`` for the PyTorch port: the same fields and
defaults, with dtypes kept as strings and mapped to ``torch.dtype`` by the
``dtype`` / ``pdtype`` properties.
"""
from __future__ import annotations

import dataclasses

import torch


def torch_dtype(name: str | torch.dtype) -> torch.dtype:
    """'bfloat16' -> torch.bfloat16 (a torch.dtype passes through)."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


def dtype_name(dt: torch.dtype) -> str:
    """torch.bfloat16 -> 'bfloat16' (the numpy/JAX name, as plan keys use)."""
    return str(dt).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | rwkv | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qkv_bias: bool = False
    activation: str = "silu"     # FFN activation; gated_mlp=True => SwiGLU
    gated_mlp: bool = True
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    norm_type: str = "rmsnorm"   # rmsnorm | layernorm
    tie_embeddings: bool = False
    # --- MoE
    n_experts: int = 0
    top_k: int = 0
    dense_residual: bool = False     # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    # --- SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    shared_attn_every: int = 0       # zamba2: shared attn block period
    # --- enc-dec (whisper)
    n_encoder_layers: int = 0
    encoder_len: int = 0             # precomputed frame embeddings (stub)
    # --- VLM (llama-3.2-vision)
    cross_attn_every: int = 0        # 1 cross-attn layer per this many
    n_image_tokens: int = 0          # precomputed patch embeddings (stub)
    # --- dtypes / execution
    param_dtype: str = "float32"
    activation_dtype: str = "bfloat16"
    optimizer: str = "adamw"         # adamw | adafactor
    attn_chunk: int = 1024
    loss_chunk: int = 512            # sequence-chunked CE (vocab memory)
    remat: bool = True
    remat_policy: str = "full"       # full | dots (save matmul outputs)
    microbatches: int = 1            # gradient-accumulation splits per step
    # --- metadata
    sub_quadratic: bool = False      # eligible for long_500k
    source: str = ""                 # provenance [ref; verified-tier]

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to 128, as the reference pads it."""
        return -(-self.vocab_size // 128) * 128

    @property
    def dtype(self) -> torch.dtype:
        return torch_dtype(self.activation_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def validate(self) -> "ModelConfig":
        if not (self.d_model % self.n_heads == 0 or self.head_dim):
            raise ValueError(f"{self.name}: d_model/n_heads mismatch")
        if (self.family in ("dense", "moe", "encdec", "vlm")
                and self.n_heads % self.n_kv_heads):
            raise ValueError(f"{self.name}: n_heads % n_kv_heads != 0")
        if self.family == "moe" and not (self.n_experts > 0 and self.top_k > 0):
            raise ValueError(f"{self.name}: moe needs experts and top_k")
        if self.family == "hybrid" and self.ssm_state <= 0:
            raise ValueError(f"{self.name}: hybrid needs ssm_state")
        return self


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k skipped: pure full-attention arch (quadratic)"
    return True, ""
