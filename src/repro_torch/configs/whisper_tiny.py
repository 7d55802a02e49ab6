"""whisper-tiny — encoder-decoder, conv frontend stubbed [arXiv:2212.04356].

Per the brief, the audio frontend is a STUB: ``input_specs()`` provides
precomputed frame embeddings (1500 frames x d_model) directly to the encoder.
The 4-layer encoder is bidirectional; the 4-layer decoder has causal self- and
cross-attention.  Decode shapes exercise the decoder (the assignment's stress
shapes exceed the model's published 448-token decoder context; positions are
handled structurally).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
    d_ff=1536, vocab=51865,
    qkv_bias=True, qk_norm=False, rope_theta=1e4,
    n_audio_frames=1500, decoder_layers=4,
)

SMOKE = CONFIG.replace(
    n_layers=2, decoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab=512, n_audio_frames=16,
    tp=1, dtype="float32", kv_chunk=32)
