"""zamba2-7b — hybrid: 81 Mamba2 layers + shared transformer blocks applied
every 27 layers (shared weights, 3 applications) [arXiv:2411.15242].

ssm_state=64, d_inner = 2 x 3584 = 7168, 112 SSM heads of 64 channels.
Shared attention block: 32 MHA heads (kv=32), d_ff 14336.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000,
    qkv_bias=False, qk_norm=False, rope_theta=1e6,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, conv_kernel=4,
    shared_attn_every=27,
)

SMOKE = CONFIG.replace(
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab=512, ssm_state=8, ssm_head_dim=16, shared_attn_every=3,
    tp=1, dtype="float32", kv_chunk=32)
