"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4 (port of
``repro.configs.qwen2_moe_a2_7b``; hf:Qwen/Qwen1.5-MoE-A2.7B).

24L d_model=2048 16H (kv=16) moe_d_ff=1408 vocab=151936.  Every layer is
MoE; the 4 shared experts mirror the checkpoint's 5632-wide shared block as
4x1408.  ``long_500k`` skipped (full attention).
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=0, vocab_size=151_936,
    n_experts=60, n_shared_experts=4, moe_top_k=4, moe_d_ff=1408,
    rope_theta=1_000_000.0,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="qwen2-moe-a2.7b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=0, vocab_size=512,
    n_experts=6, n_shared_experts=2, moe_top_k=2, moe_d_ff=48,
)
