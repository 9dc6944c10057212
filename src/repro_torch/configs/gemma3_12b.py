"""gemma3-12b [dense] — 5:1 local:global interleave, 128k context
(port of ``repro.configs.gemma3_12b``; hf:google/gemma-3-12b-pt family
numbers).

48L d_model=3840 16H (kv=8) d_ff=15360 vocab=262144.  head_dim=256;
sliding window 1024 on local layers; global layers use rope_theta=1M vs
10k local; qk-norm on.  ``long_500k`` swaps the global layers' decode path
to the paper's landmark (fast-SPSD) attention — see ``config_for_shape``.
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab_size=262_144,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    rope_theta=1_000_000.0, rope_theta_local=10_000.0,
    qk_norm=True, post_norm=True, tie_embeddings=True, scale_embed=True,
    landmark_c=512, landmark_theta=4,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="gemma3-12b-smoke", family="dense",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    window=16,
    rope_theta=1_000_000.0, rope_theta_local=10_000.0,
    qk_norm=True, post_norm=True, tie_embeddings=True, scale_embed=True,
    landmark_c=8, landmark_theta=2,
)
