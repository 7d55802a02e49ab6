"""arctic-480b — dense-MoE hybrid: 128 experts top-2 IN PARALLEL with a dense
residual MLP every layer [hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=4864, vocab=32000,
    qkv_bias=False, qk_norm=False, rope_theta=1e6,
    n_experts=128, top_k=2, expert_d_ff=4864, dense_residual=True,
    param_dtype="bfloat16", moment_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64, vocab=512, n_experts=8, top_k=2, expert_d_ff=32,
    tp=1, dtype="float32", kv_chunk=32)
