"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 (port of
``repro.configs.recurrentgemma_2b``; arXiv:2402.19427, Griffin).

26L d_model=2560 10H (kv=1, MQA) d_ff=7680 vocab=256000.  Pattern
(rglru, rglru, local) x8 + (rglru, rglru) remainder = 26 layers; window
2048.  ``long_500k`` runs natively: RG-LRU state is O(1)/token and the
attention window is bounded.
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256_000,
    layer_pattern=("rglru", "rglru", "local"),
    window=2048, lru_width=2560,
    rope_theta=10_000.0,
    tie_embeddings=True, scale_embed=True,
    mlp_variant="geglu",
)

SMOKE = ModelConfig(
    name="recurrentgemma-2b-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=192, vocab_size=512,
    layer_pattern=("rglru", "rglru", "local"),
    window=16, lru_width=64,
    tie_embeddings=True, scale_embed=True,
    mlp_variant="geglu",
)
