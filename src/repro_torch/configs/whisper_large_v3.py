"""whisper-large-v3 [audio] — encoder-decoder, conv frontend stubbed (port
of ``repro.configs.whisper_large_v3``; arXiv:2212.04356).

32L (x2: 32 enc + 32 dec) d_model=1280 20H (kv=20) d_ff=5120 vocab=51866.
The conv1d+GELU frontend is a stub, as in the reference: ``input_specs``
gives precomputed 128-mel frame embeddings (frontend_dim=128), projected
into d_model.  The decoder self-attends causally and cross-attends to the
encoder output.  Decode shapes put ``seq_len`` in the *encoder* (the cross-
attention K/V); the decoder's own cache is the standard 448 positions.
``long_500k`` skipped (enc-dec).
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, vocab_size=51_866,
    is_encdec=True, n_enc_layers=32, n_dec_layers=32, frontend_dim=128,
    mlp_variant="gelu",
)

SMOKE = ModelConfig(
    name="whisper-large-v3-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512,
    is_encdec=True, n_enc_layers=2, n_dec_layers=2, frontend_dim=16,
    mlp_variant="gelu",
)
