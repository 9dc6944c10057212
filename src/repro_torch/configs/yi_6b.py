"""yi-6b [dense] — llama-arch GQA (port of ``repro.configs.yi_6b``;
arXiv:2403.04652).

32L d_model=4096 32H (kv=4) d_ff=11008 vocab=64000.  ``long_500k`` skipped.
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab_size=64_000,
    rope_theta=10_000.0,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="yi-6b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=160, vocab_size=512,
)
