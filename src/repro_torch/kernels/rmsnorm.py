"""RMSNorm: the CUDA kernel's launcher and its plain PyTorch version.

The kernel (``csrc/rmsnorm.cu``) replaces the TPU kernel
``repro/kernels/rmsnorm.py:rmsnorm``; its source note says what bounds it
on Hopper and how its design answers that.  The plain version below is the
same math in eager PyTorch: the CPU path and the kernel's oracle.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def rmsnorm_plain(x, scale, *, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last axis, reduced in
    float32; the result keeps ``x``'s dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def rmsnorm_cuda(x, scale, *, eps: float = 1e-6):
    """Launch the RMSNorm kernel on ``x``'s card (current stream).  Raises on
    an input the kernel does not take; never falls back."""
    d = x.shape[-1]
    if not (x.is_cuda and scale.is_cuda and x.device == scale.device):
        raise ValueError("rmsnorm_cuda: x and scale must lie on one card")
    if x.dtype not in _DTYPE_CODES or scale.dtype not in _DTYPE_CODES:
        raise TypeError(f"rmsnorm_cuda: unsupported dtypes {x.dtype}, "
                        f"{scale.dtype} (float32 or bfloat16)")
    if scale.shape != (d,):
        raise ValueError(f"rmsnorm_cuda: scale {tuple(scale.shape)} != ({d},)")
    x2 = x.reshape(-1, d).contiguous()
    scale = scale.contiguous()
    out = torch.empty_like(x2)
    rows = x2.shape[0]
    if rows:
        lib = build.library()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            build.check(lib.rmsnorm_launch(
                x2.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d,
                float(eps), _DTYPE_CODES[x.dtype], _DTYPE_CODES[scale.dtype],
                stream), "rmsnorm")
    return out.reshape(x.shape)
