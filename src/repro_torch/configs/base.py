"""Architecture configuration schema + the assigned input-shape suite.

The port's copy of ``repro.configs.base``, field for field and formula for
formula; ``activation_dtype`` and ``p_dtype`` give ``torch.dtype``s.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm_hybrid | xlstm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    # attention pattern
    sliding_window: Optional[int] = None
    local_global_ratio: Optional[int] = None   # N local layers per 1 global
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0                # deepseek/kimi: dense first block(s)
    # SSM (mamba2) / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    attn_every: int = 0                # zamba2: shared attn every N mamba blocks
    # xLSTM
    slstm_every: int = 0                       # 1 sLSTM per N blocks (rest mLSTM)
    # encoder-decoder
    encoder_layers: int = 0
    encoder_seq: int = 1500                    # whisper: 30s of 20ms frames
    # modality frontend stub
    frontend: Optional[str] = None             # "audio" | "patch" | None
    frontend_dim: int = 0                      # stub embedding feature dim
    num_patches: int = 0
    # MLP variant: "swiglu" (3 mats) or "gelu" (2 mats — starcoder2/whisper)
    mlp_variant: str = "swiglu"
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # serving
    decode_only: bool = False
    sub_quadratic: bool = False                # eligible for long_500k

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def activation_dtype(self):
        return getattr(torch, self.dtype)

    @property
    def p_dtype(self):
        return getattr(torch, self.param_dtype)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + per-layer)."""
        d, hd = self.d_model, self.hd
        attn = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d)
        mats = 2 if self.mlp_variant == "gelu" else 3
        dense_mlp = mats * d * self.d_ff if self.d_ff else 0
        per_layer = attn + dense_mlp
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family == "moe":
            moe_mlp = 3 * d * self.moe_d_ff * (self.n_experts + self.n_shared_experts)
            router = d * self.n_experts
            moe_layers = self.n_layers - self.first_dense_layers
            total += self.first_dense_layers * (attn + dense_mlp)
            total += moe_layers * (attn + moe_mlp + router)
        elif self.family == "ssm_hybrid":
            d_in = self.ssm_expand * d
            nheads = d_in // self.ssm_head_dim
            ssm = d * (2 * d_in + 2 * self.ssm_state + nheads) + d_in * d
            total += self.n_layers * ssm
            if self.attn_every:
                total += attn + dense_mlp  # one shared transformer block
        elif self.family == "xlstm":
            total += self.n_layers * (4 * d * d + 2 * d * (2 * d))  # approx
        elif self.family == "encdec":
            total += (self.encoder_layers * per_layer
                      + self.n_layers * (per_layer + attn))
        else:
            total += self.n_layers * per_layer
        return int(total)

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: top-k + shared only)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        attn = (d * self.n_heads * self.hd + 2 * d * self.n_kv_heads * self.hd
                + self.n_heads * self.hd * d)
        active_mlp = (3 * d * self.moe_d_ff
                      * (self.experts_per_token + self.n_shared_experts))
        moe_layers = self.n_layers - self.first_dense_layers
        total = self.vocab * d
        total += self.first_dense_layers * (attn + 3 * d * self.d_ff)
        total += moe_layers * (attn + active_mlp + d * self.n_experts)
        return int(total)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        cfg,
        n_layers=min(cfg.n_layers, 2),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(4, max(1, cfg.n_kv_heads * 4 // max(1, cfg.n_heads))),
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
        n_experts=8 if cfg.n_experts else 0,
        n_shared_experts=min(1, cfg.n_shared_experts),
        experts_per_token=2 if cfg.experts_per_token else 0,
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=32 if cfg.ssm_state else 64,
        attn_every=2 if cfg.attn_every else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        encoder_seq=32 if cfg.encoder_layers else 1500,
        sliding_window=64 if cfg.sliding_window else None,
        num_patches=4 if cfg.num_patches else 0,
        frontend_dim=64 if cfg.frontend_dim else 0,
        first_dense_layers=min(cfg.first_dense_layers, 1),
        dtype="float32",
        param_dtype="float32",
    )
