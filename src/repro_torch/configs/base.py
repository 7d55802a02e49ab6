"""Model configuration dataclass: a copy of the reference package's
``ModelConfig`` (the port imports nothing of it).

The port reads the architecture fields (widths, heads, vocab, attention
flavour) and ``dtype``; the training and sharding fields are kept so a
config prints and compares the same as its reference twin.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


def _pad_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | vlm | ssm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128

    # attention flavour
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e6
    local_window: Optional[int] = None      # sliding-window size (local layers)
    global_every: int = 0                   # gemma3: every Nth layer is global
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    dense_residual: bool = False            # arctic: dense MLP in parallel w/ MoE
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    router_z_weight: float = 1e-3

    # SSM (mamba2) / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    conv_kernel: int = 4
    shared_attn_every: int = 0              # zamba: shared attn block cadence

    # rwkv
    rwkv_head_dim: int = 0
    rwkv_time_chunk: int = 32    # chunked matmul wkv form (0 = per-step scan)

    # vlm / audio frontends (stubs per brief: precomputed embeddings)
    n_image_tokens: int = 0
    n_audio_frames: int = 0
    decoder_layers: int = 0                 # whisper: n_layers = encoder layers

    # runtime
    dtype: str = "bfloat16"
    param_dtype: str = "float32"            # bf16 for >=200B MoE (HBM fit)
    moment_dtype: str = "float32"           # AdamW m/v storage
    remat: str = "full"                     # none | dots | full — "full"
    # saves only scan carries: the only policy whose temp footprint fits 16GB
    # HBM at train_4k for the 7B+ archs (see EXPERIMENTS.md §Dry-run)
    kv_chunk: int = 1024
    use_pallas: bool = False
    z_loss: float = 0.0
    tp: int = 16                            # model-axis size (vocab padding)

    # ---- derived -----------------------------------------------------------
    @property
    def padded_q_heads(self) -> int:
        return self.n_heads                 # heads never TP-sharded

    @property
    def padded_kv_heads(self) -> int:
        return self.n_kv_heads

    @property
    def padded_vocab(self) -> int:
        return _pad_to(self.vocab, max(self.tp * 8, 128))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim if self.rwkv_head_dim else 0

    @property
    def is_encoder_decoder(self) -> bool:
        return self.decoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the 500k-context shape."""
        return self.family in ("ssm", "hybrid") or (
            self.local_window is not None and self.global_every > 0)

    def window_for_layer(self, layer_idx: int) -> Optional[int]:
        """gemma3 5:1 pattern: every ``global_every``-th layer is global."""
        if self.local_window is None:
            return None
        if self.global_every and (layer_idx + 1) % self.global_every == 0:
            return None                    # global layer
        return self.local_window

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
