"""Flash attention over whole sequences: the CUDA kernel's launcher and its
plain PyTorch version.

Grouped-query attention of q ``(B, Sq, Hq, D)`` against k, v
``(B, Sk, Hkv, D)``: query head ``h`` reads KV head ``h // (Hq // Hkv)``,
query row ``i`` sees key ``j`` when ``j <= i`` (causal) and
``i - j < window`` (a sliding window), scores are scaled by ``D ** -0.5``.
The serving engine's whole-prompt prefill runs it in every layer.

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``repro/kernels/flash_attention.py:flash_attention``; its source note says
what bounds it on Hopper and how the design answers that.  Unlike the TPU
wrapper it takes any sequence length, not only multiples of its tile.  It
has two routes, chosen from dtype and D before the launch
(:func:`tensor_core_route`): bf16 at D 64 and 128 on the tensor cores
(wgmma and TMA), everything else on CUDA cores.

Training needs the gradients of a whole-sequence forward: the backward
kernels (``csrc/flash_attention_bwd.cu``, launched by
:func:`flash_attention_bwd_cuda` from the autograd Function in
:mod:`repro_torch.kernels.ops`) take the forward's inputs, its output and
the output's gradient, and recompute each row's log-sum-exp themselves, so
the forward kernels and their serving times are as they were.  On the CPU
autograd differentiates the plain version, which is also the backward's
oracle on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
TENSOR_CORE_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_window(window) -> None:
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} must be >= 1 "
                         "(None for global attention)")


def flash_attention_plain(q, k, v, *, causal: bool = True, window=None):
    """Masked softmax attention in float32: the CPU path and the kernel's
    oracle (``repro.kernels.ref.flash_attention``).

    q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D) in q's
    dtype.  A row that sees no key (only with ``Sq > Sk`` and a window) is
    zeros, as in the kernel, where the reference would average every key.
    """
    _check_window(window)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).to(torch.float32) * D ** -0.5
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32))
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        ok &= q_pos >= k_pos
    if window is not None:
        ok &= (q_pos - k_pos) < window
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    o = torch.where(ok.any(-1)[None, :, None, None, None], o, 0.0)
    return o.reshape(B, Sq, Hq, D).to(q.dtype)


def tensor_core_route(q) -> bool:
    """True when the kernel runs ``q``'s call on the tensor cores: bf16 at
    a head dim in :data:`TENSOR_CORE_HEAD_DIMS`.  Float32 stays on CUDA
    cores (its 2e-4 limit rules out TF32 and bf16 operands), and so do the
    other head dims."""
    return q.dtype == torch.bfloat16 and q.shape[-1] in TENSOR_CORE_HEAD_DIMS


def _strided(t):
    """``t`` itself when the kernel can read it through its strides (head
    dim contiguous, 16-byte aligned rows), else a contiguous copy."""
    vec = 16 // t.element_size()
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(s % vec == 0 for s in t.stride()[:-1]))
    return t if ok else t.contiguous()


def flash_attention_cuda(q, k, v, *, causal: bool = True, window=None):
    """Launch the flash-attention kernel on ``q``'s card (current stream).
    Shapes as in :func:`flash_attention_plain`; q, k and v share one dtype
    (float32 or bfloat16) and D is one of 16, 32, 64, 128, 256.  Raises on
    anything else; never falls back.  bf16 at D 64 and 128 runs on the
    tensor cores, everything else on CUDA cores (:func:`tensor_core_route`);
    a call on either route that fails to build or launch raises and never
    runs the other."""
    _check_window(window)
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, Dk = k.shape
    dev = q.device
    if not q.is_cuda:
        raise ValueError("flash_attention_cuda: q must lie on a card")
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"flash_attention_cuda: {name} on {t.device}, "
                             f"q on {dev}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda: dtypes q={q.dtype} "
                        f"k={k.dtype} v={v.dtype}; want one of "
                        "float32/bfloat16 for all three")
    if (v.shape != k.shape or k.shape[0] != B or Dk != D or Hkv == 0
            or Hq % Hkv):
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)} vs "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {D} not in "
                         f"{HEAD_DIMS}")
    out = torch.empty(B, Sq, Hq, D, dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    if Sk == 0:
        return out.zero_()
    q, k, v = _strided(q), _strided(k), _strided(v)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Sq, Sk, Hq, Hkv, D, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], int(causal), 0 if window is None else int(window),
            float(D ** -0.5), _DTYPE_CODES[q.dtype],
            int(tensor_core_route(q)), stream),
            "flash_attention")
    return out


def flash_attention_bwd_cuda(q, k, v, out, dout, *, causal: bool = True,
                             window=None):
    """Launch the flash-attention backward (``csrc/flash_attention_bwd.cu``)
    on ``q``'s card: the gradients ``(dq, dk, dv)`` of a whole-sequence
    forward (``Sq == Sk``) from its inputs, its output ``out`` and the
    output's gradient ``dout``, computed in float32 on CUDA cores and
    returned in q's dtype (dk and dv summed over each KV head's query
    heads).  float32 or bfloat16, D one of :data:`HEAD_DIMS`.  Raises on
    anything else; never falls back."""
    _check_window(window)
    B, S, Hq, D = q.shape
    dev = q.device
    if not q.is_cuda:
        raise ValueError("flash_attention_bwd_cuda: q must lie on a card")
    for name, t in (("k", k), ("v", v), ("out", out), ("dout", dout)):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"flash_attention_bwd_cuda: {name} is "
                             f"{t.dtype} on {t.device}, q {q.dtype} on {dev}")
    Hkv = k.shape[2]
    if (k.shape != (B, S, Hkv, D) or v.shape != k.shape
            or out.shape != q.shape or dout.shape != q.shape or Hkv == 0
            or Hq % Hkv):
        raise ValueError(f"flash_attention_bwd_cuda: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}: "
                         "want Sq == Sk and GQA heads")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention_bwd_cuda: dtype {q.dtype}; want "
                        "float32 or bfloat16")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd_cuda: head dim {D} not in "
                         f"{HEAD_DIMS}")
    q, k, v, out, dout = (t.contiguous() for t in (q, k, v, out, dout))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    lse = torch.empty(B, Hq, S, dtype=torch.float32, device=dev)
    delta = torch.empty_like(lse)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), B, S, Hq, Hkv, D, int(causal),
            0 if window is None else int(window), float(D ** -0.5),
            _DTYPE_CODES[q.dtype], stream), "flash_attention_bwd")
    return dq, dk, dv
