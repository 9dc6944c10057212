"""chameleon-34b [vlm] — early-fusion VQ image tokens (port of
``repro.configs.chameleon_34b``; arXiv:2405.09818).

48L d_model=8192 64H (kv=8) d_ff=22016 vocab=65536.  The modality frontend
is a stub, as in the reference: a batch may carry precomputed patch
embeddings (``"patches"``, (B, n_patch, d_model)) that replace the leading
token positions (early fusion, ``models.model._embed_inputs``).  QK-norm on
(chameleon's divergence fix).  ``long_500k`` skipped.
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab_size=65_536,
    qk_norm=True,
    rope_theta=10_000.0,
    fsdp=True,
)

SMOKE = ModelConfig(
    name="chameleon-34b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=192, vocab_size=512,
    qk_norm=True,
)
