"""deepseek-v3-671b [moe] — MLA + 1 shared + 256 routed top-8 + MTP (port
of ``repro.configs.deepseek_v3_671b``; arXiv:2412.19437).

61L d_model=7168 128H d_ff(moe)=2048 vocab=129280; first 3 layers dense
(d_ff=18432); MLA q_lora=1536 kv_lora=512 nope=128 rope=64 v=128.
Parameters are held in bf16 (``param_dtype``), as in the reference.  The
MTP head's parameters are initialized (the trees match the reference's);
serving does not read them.
"""
from repro_torch.configs.base import ModelConfig

FULL = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=0, vocab_size=129_280,
    n_experts=256, n_shared_experts=1, moe_top_k=8, moe_d_ff=2048,
    first_k_dense=3, dense_d_ff=18432,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    mtp=True,
    rope_theta=10_000.0,
    param_dtype="bfloat16",
    fsdp=True,
)

SMOKE = ModelConfig(
    name="deepseek-v3-671b-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=0, vocab_size=512,
    n_experts=8, n_shared_experts=1, moe_top_k=2, moe_d_ff=48,
    first_k_dense=1, dense_d_ff=128,
    use_mla=True, q_lora_rank=24, kv_lora_rank=16,
    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    mtp=True,
)
