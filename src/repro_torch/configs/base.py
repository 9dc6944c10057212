"""Config schema of the port: architectures and input shapes (port of
``repro.configs.base``).

``ModelConfig`` is the single source of truth a model is built from; its
fields are the reference's, so a reference config carries over field by
field.  ``cdtype``/``pdtype`` are torch dtypes here.  ``ShapeConfig`` names
one of the four assigned input shapes.  The reference's ``input_specs``
(shape stand-ins for the JAX dry run) has no counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention ---
    rope_theta: float = 10_000.0
    rope_theta_local: float = 10_000.0
    qk_norm: bool = False
    window: Optional[int] = None          # sliding-window size for 'local'
    layer_pattern: Tuple[str, ...] = ("attn",)
    attn_impl: str = "xla"                # xla | pallas (one function here)
    # landmark (paper fast-SPSD) attention for long-context decode
    landmark_c: int = 256
    landmark_theta: int = 4
    use_landmark_decode: bool = False     # global layers use LandmarkState cache
    landmark_selection: str = "strided"   # or a SelectionPolicy registry name

    # --- mlp ---
    mlp_variant: str = "swiglu"           # swiglu | geglu | relu2 | gelu

    # --- moe ---
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    first_k_dense: int = 0
    dense_d_ff: int = 0
    moe_impl: str = "gather"

    # --- MLA (deepseek) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mla_absorb: bool = True

    # --- heads / embeddings ---
    tie_embeddings: bool = False
    scale_embed: bool = False
    norm_eps: float = 1e-6
    post_norm: bool = False               # gemma-style sandwich norm
    mtp: bool = False

    # --- encoder-decoder (whisper) ---
    is_encdec: bool = False
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    frontend_dim: int = 0

    # --- recurrent ---
    rglru_conv_width: int = 4
    lru_width: int = 0
    mlstm_chunk: int = 256

    # --- numerics / compilation (remat, unroll_scans, seq_parallel_attn,
    # chunk_q and fsdp steer the reference's XLA compile and mesh and are
    # kept so configs carry over; scan_layers says how the reference stores
    # its superblocks, which the converter reads) ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "full"
    scan_layers: bool = True
    unroll_scans: bool = False
    seq_parallel_attn: bool = False
    chunk_q: int = 1024
    fsdp: bool = False
    logits_softcap: Optional[float] = None

    # ----- derived -----
    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# archs that can run long_500k (sub-quadratic path exists)
LONG_CONTEXT_OK = {"xlstm-125m", "recurrentgemma-2b", "gemma3-12b"}
