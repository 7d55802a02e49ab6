"""Architecture registry: ``--arch <id>`` resolution for the ported archs.

Every arch of the reference registry is here: the dense decoders
(qwen2-7b, qwen2.5-14b, qwen3-1.7b, and gemma3-4b with its sliding-window
layers), the MoE decoders (qwen3-moe-235b-a22b, arctic-480b), rwkv6-3b,
zamba2-7b and the multimodal pair (llava-next-mistral-7b, whisper-tiny).
"""
from __future__ import annotations

import importlib

_MODULES = {
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "qwen2.5-14b": "repro_torch.configs.qwen2p5_14b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1p7b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "rwkv6-3b": "repro_torch.configs.rwkv6_3b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
}


def list_archs() -> list[str]:
    """The arch ids this package can build."""
    return list(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"arch {arch!r} is not ported yet; ported: "
                       f"{sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str):
    """The full-size config of ``arch``."""
    return _module(arch).CONFIG


def smoke_config(arch: str):
    """The small test config of ``arch``."""
    return _module(arch).SMOKE
