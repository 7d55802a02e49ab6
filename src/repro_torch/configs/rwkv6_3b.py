"""rwkv6-3b (Finch) — attention-free, data-dependent decay [arXiv:2404.05892].

40 heads x 64 channels; channel-mix FFN hidden 8960; vocab 65536.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=8960, vocab=65536,
    rope_theta=0.0,
    rwkv_head_dim=64,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, d_ff=128, vocab=512, rwkv_head_dim=16,
    tp=1, dtype="float32")
