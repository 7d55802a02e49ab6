"""The port's training launcher on every registered arch, on the CPU: one
step of the SMOKE config at batch 2 and 32 tokens ends either in a finite
loss or in a ``NotImplementedError`` that names ROADMAP A13b (the families
whose training is not ported yet: llava and whisper; the decoders, the MoE
models, rwkv6 and zamba2 train).  Anything else, an ``AttributeError``
from a model class without ``loss`` say, fails."""
import math

import pytest

from repro_torch.configs.registry import list_archs
from repro_torch.launch import train


@pytest.mark.parametrize("arch", list_archs())
def test_train_launcher_trains_or_refuses(arch, capsys):
    try:
        result = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                             "--steps", "1", "--batch", "2", "--seq", "32"])
    except NotImplementedError as e:
        assert "A13b" in str(e), f"{arch}: refusal without A13b: {e}"
        return
    history = result["history"]
    assert len(history) == 1
    assert math.isfinite(history[0]["loss"]), history
    assert f"[train] {arch}: loss" in capsys.readouterr().out
