"""ArchConfig: one dataclass describing every architecture of the LM stack,
plus the shape cells (train_4k / prefill_32k / decode_32k / long_500k).
The port of `repro/configs/base.py`, field for field; `dtype` is a
`torch.dtype`."""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                # 0 -> d_model // n_heads
    # attention
    attn_kind: str = "gqa"         # gqa | mla | none
    window: int = 0                # >0 -> sliding-window attention
    rope_theta: float = 1e4
    # hybrid (jamba): within each block of `hybrid_period` layers, the layer
    # at index `attn_position` is attention, the rest are mamba.
    hybrid_period: int = 0
    attn_position: int = 0
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1             # MoE replaces FFN every k-th layer
    dense_residual_ff: int = 0     # arctic: parallel dense FFN width
    capacity_factor: float = 1.25
    # mla
    q_lora: int = 0
    kv_lora: int = 0
    d_nope: int = 0
    d_rope: int = 0
    d_v: int = 0
    # ssm
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    # enc-dec / frontends
    enc_layers: int = 0
    frontend: str = "none"         # none | audio_stub | vision_stub
    n_patches: int = 0             # vlm: stub patch embeddings prepended
    cross_len: int = 0             # encdec decode: encoder context length
    # numerics / structure
    mlp_kind: str = "swiglu"       # swiglu | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    # carried only: eager inference keeps no activations for a backward
    # and has no scan to build
    remat: bool = True
    scan_layers: bool = True
    attn_chunk: int = 512
    # carried only: the port's prefill always runs its attention kernel
    attn_impl: str = "xla"
    moe_group: int = 1024
    # train-time gradient-accumulation microbatches (activation peak ~ 1/k)
    grad_accum: int = 1
    # decode-time KV sequence sharding factor (model-axis shards)
    kv_shards: int = 1

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // max(self.n_heads, 1))

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.param_dtype == "bfloat16" else torch.float32

    def scaled(self, **kw) -> "ArchConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}

# long_500k is decode with a 500k-token context: run only for sub-quadratic
# context handling (SSM state / hybrid / bounded-window SWA).
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def supports_cell(cfg: ArchConfig, cell: ShapeCell) -> tuple[bool, str]:
    if cell.name == "long_500k":
        if cfg.family in SUBQUADRATIC_FAMILIES or cfg.window > 0:
            return True, ""
        return False, "full-attention arch: 500k dense KV cache is the quadratic regime (skip per assignment)"
    return True, ""
