"""Flash attention over whole sequences: the CUDA kernel's launcher and its
plain PyTorch version.

Grouped-query attention of q ``(B, Sq, Hq, D)`` against k, v
``(B, Sk, Hkv, D)``: query head ``h`` reads KV head ``h // (Hq // Hkv)``,
query row ``i`` sits at position ``p = q_offset + i`` (``q_offset`` 0
unless given) and sees key ``j`` when ``j <= p`` (causal) and
``p - j < window`` (a sliding window), scores are scaled by ``D ** -0.5``.
The serving engine's whole-prompt prefill runs it in every layer; training
over a mesh runs a rank's block of queries with ``q_offset`` its first
position against the keys up to its last (sequence parallelism).

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``repro/kernels/flash_attention.py:flash_attention``; its source note says
what bounds it on Hopper and how the design answers that.  Unlike the TPU
wrapper it takes any sequence length, not only multiples of its tile.  It
has two routes, chosen from dtype and D before the launch
(:func:`tensor_core_route`): bf16 at D 64, 128 and 256 on the tensor cores
(wgmma and TMA), everything else on CUDA cores.  A head dim the kernels
are not built for (zamba2's 112) runs zero-padded to the next one
(:func:`padded_head_dim`) with the scale of its own: zero columns add
nothing to a score, and the output's extra columns, zeros, are cut off.
So bf16 at D 112 takes the tensor-core route at D 128 both ways; a
CUDA-core instantiation at D 112 would have run its products on CUDA
cores at 7/8 of the work, where the tensor cores at 8/7 of it are far
faster.

Training needs the gradients of the forward: the backward
kernels (``csrc/flash_attention_bwd.cu``, launched by
:func:`flash_attention_bwd_cuda` from the autograd Function in
:mod:`repro_torch.kernels.ops`) take the forward's inputs, its output and
the output's gradient.  They too have two routes
(:func:`backward_tensor_core_route`): bf16 at D 64, 128 and 256 on the
tensor cores, which read each row's log-sum-exp from the forward
(``flash_attention_cuda(..., with_lse=True)``; serving asks for none, and
its launches write none); float32 and bf16 D 16 and 32 on CUDA cores,
which recompute it.  bf16 at D 256 also has CUDA-core kernels, taken only
when asked for by ``tensor_cores=False`` (to time the two routes side by
side).  On the CPU autograd differentiates the plain version,
which is also the backward's oracle on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
TENSOR_CORE_HEAD_DIMS = (64, 128, 256)
BACKWARD_TENSOR_CORE_HEAD_DIMS = (64, 128, 256)
LSE_ROWS = 128     # the log-sum-exp's rows are padded to the forward's block
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_window(window) -> None:
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} must be >= 1 "
                         "(None for global attention)")


def _check_offset(q_offset) -> None:
    if not isinstance(q_offset, int) or q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset!r} must be "
                         "an int >= 0")


def flash_attention_plain(q, k, v, *, causal: bool = True, window=None,
                          q_offset: int = 0):
    """Masked softmax attention in float32: the CPU path and the kernel's
    oracle (``repro.kernels.ref.flash_attention``; with ``q_offset`` the
    mask of ``repro.models.attention.gqa_attention(q_offset=)``).

    q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) -> (B, Sq, Hq, D) in q's
    dtype.  A row that sees no key (with a window, or an offset past the
    keys) is zeros, as in the kernel, where the reference would average
    every key.
    """
    _check_window(window)
    _check_offset(q_offset)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D).to(torch.float32) * D ** -0.5
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32))
    q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
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


def padded_head_dim(D: int):
    """The head dim the kernels run ``D`` at: the least of
    :data:`HEAD_DIMS` not below it (D itself when built for), None past
    the widest."""
    return next((h for h in HEAD_DIMS if h >= D), None)


def tensor_core_route(q) -> bool:
    """True when the kernel runs ``q``'s call on the tensor cores: bf16 at
    a (padded) head dim in :data:`TENSOR_CORE_HEAD_DIMS`.  Float32 stays on
    CUDA cores (its 2e-4 limit rules out TF32 and bf16 operands), and so do
    the other head dims."""
    return (q.dtype == torch.bfloat16
            and padded_head_dim(q.shape[-1]) in TENSOR_CORE_HEAD_DIMS)


def backward_tensor_core_route(q) -> bool:
    """True when the backward runs ``q``'s call on the tensor cores: bf16 at
    a (padded) head dim in :data:`BACKWARD_TENSOR_CORE_HEAD_DIMS` (at D
    256 dk and dv in blocks of their own: the kernel's note).  Float32 and
    D 16 and 32 stay on CUDA cores."""
    return (q.dtype == torch.bfloat16 and padded_head_dim(q.shape[-1])
            in BACKWARD_TENSOR_CORE_HEAD_DIMS)


def _padded(D: int, *tensors):
    """``tensors`` with their last axis zero-padded from D to
    :func:`padded_head_dim` (D)."""
    Dp = padded_head_dim(D)
    return [torch.nn.functional.pad(t, (0, Dp - D)) for t in tensors]


def lse_rows(S: int) -> int:
    """Rows of a head in the log-sum-exp the forward hands the backward:
    ``S`` rounded up to :data:`LSE_ROWS`."""
    return -(-S // LSE_ROWS) * LSE_ROWS


def _strided(t):
    """``t`` itself when the kernel can read it through its strides (head
    dim contiguous, 16-byte aligned rows), else a contiguous copy."""
    vec = 16 // t.element_size()
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(s % vec == 0 for s in t.stride()[:-1]))
    return t if ok else t.contiguous()


def flash_attention_cuda(q, k, v, *, causal: bool = True, window=None,
                         q_offset: int = 0, with_lse: bool = False):
    """Launch the flash-attention kernel on ``q``'s card (current stream).
    Shapes as in :func:`flash_attention_plain`; q, k and v share one dtype
    (float32 or bfloat16) and D is at most 256 (one of :data:`HEAD_DIMS`,
    or zero-padded to the next, :func:`padded_head_dim`).  Raises on
    anything else; never falls back.  bf16 at D 64, 128 and 256 runs on the
    tensor cores, everything else on CUDA cores (:func:`tensor_core_route`);
    a call on either route that fails to build or launch raises and never
    runs the other.  ``q_offset``: the position of query row 0.

    ``with_lse`` (only where :func:`backward_tensor_core_route` holds)
    returns ``(out, lse)``: each row's log-sum-exp of the scaled scores in
    log2 units, float32 ``(B, Hq, lse_rows(Sq))`` (rows past ``Sq`` are
    written too), which the tensor-core backward reads."""
    _check_window(window)
    _check_offset(q_offset)
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
    if padded_head_dim(D) is None:
        raise ValueError(f"flash_attention_cuda: head dim {D} above every "
                         f"built one {HEAD_DIMS}")
    if with_lse and not backward_tensor_core_route(q):
        raise ValueError("flash_attention_cuda: with_lse is for the "
                         "tensor-core backward (bf16, D in "
                         f"{BACKWARD_TENSOR_CORE_HEAD_DIMS}); got {q.dtype} "
                         f"at D {D}")
    out = torch.empty(B, Sq, Hq, D, dtype=q.dtype, device=dev)
    lse = (torch.empty(B, Hq, lse_rows(Sq), dtype=torch.float32, device=dev)
           if with_lse else None)
    if out.numel() == 0 or Sk == 0:
        if lse is not None:
            lse.fill_(float("inf"))
        out = out.zero_()
        return (out, lse) if with_lse else out
    scale = float(D ** -0.5)
    Dp = padded_head_dim(D)
    if Dp != D:
        q, k, v = _padded(D, q, k, v)
        wide = torch.empty(B, Sq, Hq, Dp, dtype=q.dtype, device=dev)
    else:
        q, k, v = _strided(q), _strided(k), _strided(v)
        wide = out
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), wide.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, Sq, Sk, Hq, Hkv, Dp, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], int(causal), 0 if window is None else int(window),
            q_offset, scale, _DTYPE_CODES[q.dtype],
            int(tensor_core_route(q)), stream),
            "flash_attention")
    if wide is not out:
        out.copy_(wide[..., :D])
    return (out, lse) if with_lse else out


def flash_attention_bwd_cuda(q, k, v, out, dout, *, causal: bool = True,
                             window=None, q_offset: int = 0, lse=None,
                             tensor_cores=None):
    """Launch the flash-attention backward (``csrc/flash_attention_bwd.cu``)
    on ``q``'s card: the gradients ``(dq, dk, dv)`` of the forward of the
    same ``causal``, ``window`` and ``q_offset`` from its inputs, its output
    ``out`` and the output's gradient ``dout``, in q's dtype (dk and dv
    summed over each KV head's query heads).  float32 or bfloat16, D one of
    :data:`HEAD_DIMS`.

    Where :func:`backward_tensor_core_route` holds the kernels run on the
    tensor cores and need ``lse``, the forward's
    (``flash_attention_cuda(..., with_lse=True)``); elsewhere they run on
    CUDA cores in float32, recompute it, and ``lse`` must be None.
    ``tensor_cores`` None follows the rule; False takes the CUDA-core
    kernels at bf16 D 256 (lse None), which exist there to be timed beside
    the tensor cores (at bf16 D 64 and 128 there are none: it raises);
    True raises where the rule does not hold.  A call on either route that
    fails to build or launch raises and never runs the other.  Raises on
    anything else; never falls back."""
    _check_window(window)
    _check_offset(q_offset)
    B, Sq, Hq, D = q.shape
    dev = q.device
    if not q.is_cuda:
        raise ValueError("flash_attention_bwd_cuda: q must lie on a card")
    for name, t in (("k", k), ("v", v), ("out", out), ("dout", dout)):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"flash_attention_bwd_cuda: {name} is "
                             f"{t.dtype} on {t.device}, q {q.dtype} on {dev}")
    Sk, Hkv = k.shape[1], k.shape[2]
    if (k.shape != (B, Sk, Hkv, D) or v.shape != k.shape
            or out.shape != q.shape or dout.shape != q.shape or Hkv == 0
            or Hq % Hkv):
        raise ValueError(f"flash_attention_bwd_cuda: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}: "
                         "want GQA heads")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention_bwd_cuda: dtype {q.dtype}; want "
                        "float32 or bfloat16")
    if padded_head_dim(D) is None:
        raise ValueError(f"flash_attention_bwd_cuda: head dim {D} above "
                         f"every built one {HEAD_DIMS}")
    tc = backward_tensor_core_route(q)
    if tensor_cores is not None and bool(tensor_cores) != tc:
        if tensor_cores or padded_head_dim(D) != 256:
            raise ValueError(
                "flash_attention_bwd_cuda: no "
                f"{'tensor' if tensor_cores else 'CUDA'}-core route for "
                f"{q.dtype} at D {D} (the tensor cores take bf16 at D "
                f"{BACKWARD_TENSOR_CORE_HEAD_DIMS}; CUDA cores the rest, "
                "and bf16 at D 256 when asked)")
        tc = False
    rows = lse_rows(Sq) if tc else Sq
    if tc and (lse is None or lse.shape != (B, Hq, rows)
               or lse.dtype != torch.float32 or lse.device != dev
               or not lse.is_contiguous() or lse.data_ptr() % 16):
        got = None if lse is None else (lse.dtype, tuple(lse.shape),
                                        lse.device)
        raise ValueError("flash_attention_bwd_cuda: the tensor-core route "
                         "needs the forward's lse, contiguous float32 "
                         f"{(B, Hq, rows)} on {dev} (the kernel copies "
                         f"16-byte aligned slices of it); got {got}")
    if not tc and lse is not None:
        raise ValueError("flash_attention_bwd_cuda: the CUDA-core route "
                         f"({q.dtype}, D {D}) recomputes the log-sum-exp; "
                         "pass lse=None")
    scale = float(D ** -0.5)
    Dp = padded_head_dim(D)
    if Dp != D:
        q, k, v, out, dout = _padded(D, q, k, v, out, dout)
    q, k, v, out, dout = (t.contiguous() for t in (q, k, v, out, dout))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or Sk == 0:
        return tuple(t[..., :D].zero_() for t in (dq, dk, dv))
    if not tc:
        lse = torch.empty(B, Hq, rows, dtype=torch.float32, device=dev)
    delta = torch.empty(B, Hq, rows, dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), B, Sq, Sk, q_offset, Hq, Hkv, Dp,
            int(causal), 0 if window is None else int(window), scale,
            _DTYPE_CODES[q.dtype], int(tc), stream), "flash_attention_bwd")
    if Dp != D:
        return tuple(t[..., :D].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv
