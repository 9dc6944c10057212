"""Config schema of the port: architectures and input shapes (port of
``repro.configs.base``).

``ModelConfig`` is the single source of truth a model is built from; its
fields are the reference's, so a reference config carries over field by
field.  ``cdtype``/``pdtype`` are torch dtypes here; the parameter
arithmetic (``param_count``, ``active_param_count``) is the reference's,
line for line.  ``ShapeConfig`` names one of the four assigned input
shapes.  The reference's ``input_specs`` (shape stand-ins for the JAX dry
run) is not ported yet (ROADMAP A11-rest.6).
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
    moe_impl: str = "gather"              # gather | shard_map (one device:
                                          # the gather path, as the reference)

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

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks)."""
        d, v = self.d_model, self.vocab_size
        total = v * d                                    # embed
        if not self.tie_embeddings:
            total += v * d                               # unembed
        for i, kind in enumerate(
                [self.layer_pattern[j % len(self.layer_pattern)]
                 for j in range(self.n_layers)]):
            total += self._mixer_params(kind) + self._mlp_params(i)
            total += 2 * d                               # two norms
        if self.is_encdec:
            # decoder self+cross blocks
            for _ in range(self.n_dec_layers):
                total += 2 * self._mixer_params("attn") + self._mlp_params(0)
                total += 3 * d
        return int(total)

    def _mixer_params(self, kind: str) -> int:
        d, h, kv, hd = (self.d_model, self.n_heads, self.n_kv_heads,
                        self.head_dim)
        if kind in ("attn", "local", "global", "xattn"):
            if self.use_mla:
                qp = d * self.q_lora_rank + self.q_lora_rank * h * (
                    self.qk_nope_dim + self.qk_rope_dim)
                kvp = d * (self.kv_lora_rank + self.qk_rope_dim)
                kvp += self.kv_lora_rank * h * (self.qk_nope_dim
                                                + self.v_head_dim)
                op = h * self.v_head_dim * d
                return qp + kvp + op
            return d * h * hd + 2 * d * kv * hd + h * hd * d
        if kind == "mlstm":
            dq = h * hd
            return d * 2 * dq + 2 * dq * hd * 0 + 3 * d * dq + dq * d
        if kind == "slstm":
            return 4 * d * h * hd + 4 * h * hd * hd // max(h, 1)
        if kind == "rglru":
            w = self.lru_width or d
            return 2 * d * w + w * self.rglru_conv_width + 2 * w * w + w * d
        return 0

    def _mlp_params(self, layer_idx: int) -> int:
        d = self.d_model
        if self.n_experts and layer_idx >= self.first_k_dense:
            e = self.n_experts * 3 * d * self.moe_d_ff
            e += self.n_shared_experts * 3 * d * self.moe_d_ff
            e += d * self.n_experts                      # router
            return e
        ff = self.dense_d_ff if (self.n_experts
                                 and layer_idx < self.first_k_dense) \
            else self.d_ff
        if ff == 0:
            return 0
        mult = 3 if self.mlp_variant in ("swiglu", "geglu") else 2
        return mult * d * ff

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k + shared only)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        inactive = (self.n_experts - self.moe_top_k) * 3 * d * self.moe_d_ff
        n_moe_layers = self.n_layers - self.first_k_dense
        return int(total - n_moe_layers * inactive)


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
