"""xlstm-125m [ssm] — sLSTM + mLSTM blocks (port of
``repro.configs.xlstm_125m``; arXiv:2405.04517).

12L d_model=768 4H (kv=4) d_ff=0 vocab=50304.  Alternating mLSTM/sLSTM
blocks; the blocks carry their own up/down projections so there is no
separate MLP (d_ff=0).  long_500k runs natively: both mixers are recurrent
(O(1) state per token).
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, head_dim=192,
    d_ff=0, vocab_size=50304,
    layer_pattern=("mlstm", "slstm"),
    tie_embeddings=True,
    mlstm_chunk=256,
)

SMOKE = ModelConfig(
    name="xlstm-125m-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=0, vocab_size=512,
    layer_pattern=("mlstm", "slstm"),
    tie_embeddings=True,
    mlstm_chunk=32,
)
