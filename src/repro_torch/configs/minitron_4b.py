"""minitron-4b [dense] — width-pruned Nemotron-4 (port of
``repro.configs.minitron_4b``; arXiv:2407.14679).

32L d_model=3072 24H (kv=8) d_ff=9216 vocab=256000.  Plain GQA decoder with
squared-relu MLP (nemotron family).  Pure full attention: ``long_500k`` is
skipped.
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=9216, vocab_size=256_000,
    mlp_variant="relu2",
    rope_theta=10_000.0,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="minitron-4b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=192, vocab_size=512,
    mlp_variant="relu2",
)
