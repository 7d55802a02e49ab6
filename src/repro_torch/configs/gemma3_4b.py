"""gemma3-4b — dense, 5:1 local:global sliding-window, 128k context
[hf:google/gemma-3 family].  Every 6th layer is global; local window 1024."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=10240, vocab=262144,
    qkv_bias=False, qk_norm=True, rope_theta=1e6,
    local_window=1024, global_every=6,
)

SMOKE = CONFIG.replace(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, local_window=8, global_every=3,
    tp=1, dtype="float32", kv_chunk=32)
