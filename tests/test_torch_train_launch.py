"""The port's training launcher on every registered arch, on the CPU: one
step of the SMOKE config at batch 2 and 32 tokens ends in a finite loss
(every family trains: the decoders, the MoE models, llava with its image
prefix, rwkv6, zamba2 and whisper).  Anything else, an exception from a
model class without ``loss`` say, fails."""
import math

import pytest

from repro_torch.configs.registry import list_archs
from repro_torch.launch import train


@pytest.mark.parametrize("arch", list_archs())
def test_train_launcher_trains_or_refuses(arch, capsys):
    result = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                         "--steps", "1", "--batch", "2", "--seq", "32"])
    history = result["history"]
    assert len(history) == 1
    assert math.isfinite(history[0]["loss"]), history
    assert f"[train] {arch}: loss" in capsys.readouterr().out
