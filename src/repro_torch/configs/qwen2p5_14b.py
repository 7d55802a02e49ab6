"""qwen2.5-14b — dense, GQA, QKV bias [hf:Qwen/Qwen2.5 family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=13824, vocab=152064,
    qkv_bias=True, qk_norm=False, rope_theta=1e6,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, tp=1, dtype="float32", kv_chunk=32)
