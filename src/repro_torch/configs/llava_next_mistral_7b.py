"""llava-next-mistral-7b — Mistral-7B backbone + anyres vision stub
[hf:llava-hf/llava-v1.6-mistral-7b-hf].

Per the brief, the modality frontend is a STUB: ``input_specs()`` provides
precomputed patch embeddings (anyres: 576 base + 4 tiles x 576 = 2880 image
tokens), which are concatenated in front of the text embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=32000,
    qkv_bias=False, qk_norm=False, rope_theta=1e6,
    n_image_tokens=2880,
)

SMOKE = CONFIG.replace(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=512, n_image_tokens=8,
    tp=1, dtype="float32", kv_chunk=32)
