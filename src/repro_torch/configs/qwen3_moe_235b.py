"""qwen3-moe-235b-a22b — 128 experts top-8, qk_norm [hf:Qwen/Qwen3-MoE]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936,
    qkv_bias=False, qk_norm=True, rope_theta=1e6,
    n_experts=128, top_k=8, expert_d_ff=1536, dense_residual=False,
    param_dtype="bfloat16", moment_dtype="bfloat16",
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=64, vocab=512, n_experts=8, top_k=4, expert_d_ff=32,
    tp=1, dtype="float32", kv_chunk=32)
