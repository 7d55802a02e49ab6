"""RMSNorm and its two fused variants: the CUDA kernel's launchers and their
plain PyTorch versions.

The kernel (``csrc/rmsnorm.cu``) replaces the TPU kernel
``repro/kernels/rmsnorm.py:rmsnorm``; its source note says what bounds it
on Hopper and how its design answers that.  Beside the plain norm it fuses
the op that the served models run right before it:

- ``add_rmsnorm(x, delta, scale) -> (s, y)``: ``s = x + delta``, the new
  residual stream, bit for bit PyTorch's sum, and ``y`` its norm; with
  ``keep_sum=False`` (a model's final norm) ``s`` is not stored and comes
  back None;
- ``gated_rmsnorm(y, z, scale)``: Mamba-2's ``rmsnorm(y.to(z.dtype) *
  silu(z))``, y float32, with the same roundings.

The plain versions below are the same ops in eager PyTorch, in the order
the models ran them before the fusion: the CPU path and the kernel's
oracle.  Training differentiates the plain versions through autograd on
the CPU; on a card the backward of all three is a kernel of the same source
(:func:`rmsnorm_bwd_cuda`, :func:`gated_rmsnorm_bwd_cuda`, wrapped as
autograd Functions in :mod:`repro_torch.kernels.ops`), held against
autograd through the plain versions.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def rmsnorm_plain(x, scale, *, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last axis, reduced in
    float32; the result keeps ``x``'s dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def add_rmsnorm_plain(x, delta, scale, *, eps: float = 1e-6,
                      keep_sum: bool = True):
    """``(s, rmsnorm(s))`` with ``s = x + delta``; ``s`` None unless
    ``keep_sum``."""
    s = x + delta
    return s if keep_sum else None, rmsnorm_plain(s, scale, eps=eps)


def gated_rmsnorm_plain(y, z, scale, *, eps: float = 1e-6):
    """``rmsnorm(y.to(z.dtype) * silu(z))``; the result in ``z``'s dtype."""
    return rmsnorm_plain(y.to(z.dtype) * F.silu(z), scale, eps=eps)


def _library():
    global _lib
    if _lib is None:
        _lib = build.library()
    return _lib


def _card(name, x, scale, *others) -> int:
    """The index of the card ``x`` lies on, after the checks every launcher
    makes: every input on that card, ``others`` of ``x``'s shape, ``scale``
    float32 or bfloat16 of shape (d,).  Device indices are compared as
    ints: a launch is one of ~169 a zamba2 step, so its host cost counts."""
    idx = x.get_device()
    if idx < 0 or any(t.get_device() != idx for t in (scale, *others)):
        raise ValueError(f"{name}: every input must lie on one card")
    for t in others:
        if t.shape != x.shape:
            raise ValueError(f"{name}: shapes {tuple(x.shape)} and "
                             f"{tuple(t.shape)} differ")
    if scale.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: unsupported scale dtype {scale.dtype} "
                        "(float32 or bfloat16)")
    if scale.shape != (x.shape[-1],):
        raise ValueError(f"{name}: scale {tuple(scale.shape)} != "
                         f"({x.shape[-1]},)")
    return idx


def _contiguous(t):
    return t if t.is_contiguous() else t.contiguous()


def _aligned(t):
    """``t`` contiguous and 16-byte aligned (the backward's vector loads),
    itself where it already is, else a copy: the backward's layout follows
    (rows, d, dtype) alone, never a pointer."""
    t = _contiguous(t)
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(name, fn, ptrs, x, idx, eps, dtype, scale) -> None:
    """Call the C entry point ``fn`` on ``x``'s rows, on card ``idx``'s
    current stream: ``fn(*ptrs, rows, d, eps, dtype code, scale dtype code,
    stream)``.  The raw stream comes from PyTorch's C binding
    (``torch.cuda.current_stream()`` builds a Stream object a call)."""
    n = x.numel()
    if not n:
        return
    d = x.shape[-1]
    rows = n // d
    args = (*ptrs, rows, d, eps, _DTYPE_CODES[dtype],
            _DTYPE_CODES[scale.dtype])
    if idx == torch._C._cuda_getDevice():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    build.check(err, name)


def rmsnorm_cuda(x, scale, *, eps: float = 1e-6):
    """Launch the RMSNorm kernel on ``x``'s card (current stream).  Raises on
    an input the kernel does not take; never falls back."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"rmsnorm_cuda: unsupported dtype {x.dtype} "
                        "(float32 or bfloat16)")
    idx = _card("rmsnorm_cuda", x, scale)
    x, scale = _contiguous(x), _contiguous(scale)
    out = torch.empty_like(x)
    _launch("rmsnorm", _library().rmsnorm_launch,
            (x.data_ptr(), scale.data_ptr(), out.data_ptr()), x, idx, eps,
            x.dtype, scale)
    return out


def add_rmsnorm_cuda(x, delta, scale, *, eps: float = 1e-6,
                     keep_sum: bool = True):
    """Launch the fused residual add and RMSNorm: ``(s, y)``, ``s = x +
    delta`` in ``x``'s dtype and ``y`` its norm, both fresh tensors; with
    ``keep_sum`` False the kernel does not store ``s`` and it is None."""
    if x.dtype not in _DTYPE_CODES or delta.dtype != x.dtype:
        raise TypeError(f"add_rmsnorm_cuda: unsupported dtypes {x.dtype}, "
                        f"{delta.dtype} (both float32 or both bfloat16)")
    idx = _card("add_rmsnorm_cuda", x, scale, delta)
    x, delta, scale = _contiguous(x), _contiguous(delta), _contiguous(scale)
    s = torch.empty_like(x) if keep_sum else None
    out = torch.empty_like(x)
    _launch("add_rmsnorm", _library().add_rmsnorm_launch,
            (x.data_ptr(), delta.data_ptr(), scale.data_ptr(),
             s.data_ptr() if keep_sum else None, out.data_ptr()), x, idx, eps,
            x.dtype, scale)
    return s, out


def gated_rmsnorm_cuda(y, z, scale, *, eps: float = 1e-6):
    """Launch the fused SiLU gate and RMSNorm: ``rmsnorm(y.to(z.dtype) *
    silu(z))``, y float32, z float32 or bfloat16; the result in z's
    dtype."""
    if y.dtype != torch.float32 or z.dtype not in _DTYPE_CODES:
        raise TypeError(f"gated_rmsnorm_cuda: unsupported dtypes {y.dtype}, "
                        f"{z.dtype} (y float32, z float32 or bfloat16)")
    idx = _card("gated_rmsnorm_cuda", y, scale, z)
    y, z, scale = _contiguous(y), _contiguous(z), _contiguous(scale)
    out = torch.empty_like(z)
    _launch("gated_rmsnorm", _library().gated_rmsnorm_launch,
            (y.data_ptr(), z.data_ptr(), scale.data_ptr(), out.data_ptr()), y,
            idx, eps, z.dtype, scale)
    return out


def rmsnorm_bwd_cuda(v, dy, ds, scale, *, eps: float = 1e-6):
    """Launch B2's backward on ``v``'s card: the gradients ``(dv, dscale)``
    of ``rmsnorm(v) * scale`` from the output's gradient ``dy`` and, for
    the fused add, the sum's own ``ds`` (None: none), computed in float32;
    ``dv`` in ``v``'s dtype (for the fused add, the gradient of both
    addends), ``dscale`` in ``scale``'s, summed over the rows in a second
    kernel from per-block partials (no atomics: the same every run).  A
    block takes a row from d 1024 to 1024 16-byte vectors a row, a warp
    one elsewhere (the kernel's note)."""
    if v.dtype not in _DTYPE_CODES or dy.dtype != v.dtype or (
            ds is not None and ds.dtype != v.dtype):
        raise TypeError(f"rmsnorm_bwd_cuda: unsupported dtypes {v.dtype}, "
                        f"{dy.dtype}, {None if ds is None else ds.dtype} "
                        "(all float32 or all bfloat16)")
    others = (dy,) if ds is None else (dy, ds)
    idx = _card("rmsnorm_bwd_cuda", v, scale, *others)
    v, dy, scale = _aligned(v), _aligned(dy), _aligned(scale)
    ds = None if ds is None else _aligned(ds)
    dv = torch.empty_like(v)
    dscale = torch.empty_like(scale)
    d = v.shape[-1]
    rows = v.numel() // d if d else 0
    if not rows:
        return dv, dscale.zero_()
    lib = _library()
    blocks = lib.rmsnorm_bwd_blocks(rows, d, _DTYPE_CODES[v.dtype])
    if blocks <= 0:
        raise ValueError(f"rmsnorm_bwd_cuda: d={d} is wider than the "
                         "backward takes")
    part = torch.empty(blocks, d, dtype=torch.float32, device=v.device)
    _launch("rmsnorm_bwd", lib.rmsnorm_bwd_launch,
            (v.data_ptr(), dy.data_ptr(),
             None if ds is None else ds.data_ptr(), scale.data_ptr(),
             dv.data_ptr(), part.data_ptr(), dscale.data_ptr()), v, idx, eps,
            v.dtype, scale)
    return dv, dscale


def gated_rmsnorm_bwd_cuda(y, z, dout, scale, *, eps: float = 1e-6):
    """Launch the gated norm's backward (B2's backward kernel, gated) on
    ``y``'s card: the gradients ``(dy, dz, dscale)`` of
    :func:`gated_rmsnorm_cuda` from the output's gradient ``dout`` (in z's
    dtype): ``dy`` float32 (y's dtype; its values rounded to z's, as
    autograd through the plain version gives them), ``dz`` in z's dtype,
    ``dscale`` in scale's, summed over the rows from per-block partials
    (the same every run)."""
    if (y.dtype != torch.float32 or z.dtype not in _DTYPE_CODES
            or dout.dtype != z.dtype):
        raise TypeError(f"gated_rmsnorm_bwd_cuda: unsupported dtypes "
                        f"{y.dtype}, {z.dtype}, {dout.dtype} (y float32, z "
                        "and dout float32 or bfloat16)")
    idx = _card("gated_rmsnorm_bwd_cuda", y, scale, z, dout)
    y, z, dout, scale = (_aligned(t) for t in (y, z, dout, scale))
    dy, dz = torch.empty_like(y), torch.empty_like(z)
    dscale = torch.empty_like(scale)
    d = y.shape[-1]
    rows = y.numel() // d if d else 0
    if not rows:
        return dy, dz, dscale.zero_()
    lib = _library()
    blocks = lib.rmsnorm_bwd_blocks(rows, d, _DTYPE_CODES[z.dtype])
    if blocks <= 0:
        raise ValueError(f"gated_rmsnorm_bwd_cuda: d={d} is wider than the "
                         "backward takes")
    part = torch.empty(blocks, d, dtype=torch.float32, device=y.device)
    _launch("gated_rmsnorm_bwd", lib.gated_rmsnorm_bwd_launch,
            (y.data_ptr(), z.data_ptr(), dout.data_ptr(), scale.data_ptr(),
             dy.data_ptr(), dz.data_ptr(), part.data_ptr(),
             dscale.data_ptr()), y, idx, eps, z.dtype, scale)
    return dy, dz, dscale
