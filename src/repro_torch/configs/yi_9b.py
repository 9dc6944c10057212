"""yi-9b [dense] — llama-arch GQA (port of ``repro.configs.yi_9b``;
arXiv:2403.04652).

48L d_model=4096 32H (kv=4) d_ff=11008 vocab=64000.  (Yi-9B is the
depth-upscaled Yi-6B: same width, 48 layers.)  Pure full attention:
``long_500k`` skipped.
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab_size=64_000,
    rope_theta=10_000.0,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="yi-9b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=160, vocab_size=512,
)
