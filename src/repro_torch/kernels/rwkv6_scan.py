"""The RWKV-6 wkv recurrence: the CUDA kernel's launcher and its plain
PyTorch version.

For every batch row and head, with an f32 K x V state ``S``::

    y_t = r_t . (S + (u o k_t) v_t^T)        S <- diag(w_t) S + k_t v_t^T

over r, k, w ``(B, S, H, K)``, v ``(B, S, H, V)``, u ``(H, K)`` and an
initial state ``(B, H, K, V)`` (zeros when None).  Returns y
``(B, S, H, V)`` float32 and the final state ``(B, H, K, V)`` float32.
Every rwkv6 time-mix layer runs it, prefill and decode alike.

The kernel (``csrc/rwkv6_scan.cu``) replaces the TPU kernel
``repro/kernels/rwkv6_scan.py:rwkv6_scan``; its source note says what
bounds it on Hopper and how the design answers that.  Unlike the TPU
wrapper it takes any sequence length, not only multiples of its tile.  It
has two routes (:func:`tensor_core_route`, from shapes only): K = V = 64
and at least one chunk of steps (every rwkv6-3b prefill) run chunk-parallel
on the tensor cores, three launches over a float32 workspace the wrapper
allocates; the rest (other widths, short prompts, every decode step) runs
the time loop of one block per (batch, head) on CUDA cores.  Its backward
(:func:`rwkv6_scan_bwd_cuda`, training) has the same two routes under the
same rule (:func:`backward_tensor_core_route`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

HEAD_DIMS = (8, 16, 32, 64)        # the key widths K the kernel is built for
MAX_V = 256                        # value columns: one thread each
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TC_CHUNK, TC_SUB = 64, 16         # the tensor-core route's chunk, sub-chunk
TC_WIDTH = 64                      # ... and its K = V


def tensor_core_route(r, v) -> bool:
    """True when the kernel runs the call of ``r`` (B, S, H, K) and ``v``
    (B, S, H, V) chunk-parallel on the tensor cores: K = V = 64 and S at
    least one chunk.  Reads shapes only, so a CUDA graph can hold the
    call."""
    return (r.shape[-1] == TC_WIDTH and v.shape[-1] == TC_WIDTH
            and r.shape[1] >= TC_CHUNK)


def workspace_elems(B: int, S: int, H: int) -> int:
    """float32 elements of the tensor-core route's workspace: each
    chunk's 64 x 64 state and 64 decays, per (batch, head)."""
    nc = -(-S // TC_CHUNK)
    return B * H * nc * (TC_WIDTH * TC_WIDTH + TC_WIDTH)


def _aligned(t):
    """``t`` (contiguous) itself when the kernel can read it with 16-byte
    vector loads, else an aligned copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def rwkv6_scan_plain(r, k, v, w, u, state0=None, out_state=None):
    """The recurrence step by step in float32: the CPU path and the
    kernel's oracle (``repro.kernels.ref.rwkv6_scan``).  With
    ``out_state`` the final state is copied into it (it may be
    ``state0``) and returned."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    f32 = torch.float32
    st = torch.zeros(B, H, K, V, dtype=f32, device=r.device) \
        if state0 is None else state0.to(f32).clone()
    rf, kf, vf, wf = (t.to(f32) for t in (r, k, v, w))
    uf = u.to(f32)[..., None]                                  # (H, K, 1)
    y = torch.empty(B, S, H, V, dtype=f32, device=r.device)
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]       # (B, H, K, V)
        y[:, t] = torch.einsum("bhk,bhkv->bhv", rf[:, t], st + uf * kv)
        st = wf[:, t, :, :, None] * st + kv
    if out_state is not None:
        out_state.copy_(st)
        st = out_state
    return y, st


def rwkv6_scan_cuda(r, k, v, w, u, state0=None, out_state=None):
    """Launch the wkv kernel on ``r``'s card (current stream).  Shapes as
    in :func:`rwkv6_scan_plain`; r, k and v share one dtype (float32 or
    bfloat16, converted in the kernel); w, u, state0 and out_state are
    float32; K is one of 8, 16, 32, 64 and V at most 256.  ``out_state``
    (contiguous) receives the final state in place and may be ``state0``.
    The route follows :func:`tensor_core_route`; a call on either route
    that fails to build or launch raises and never runs the other.
    Raises on anything else; never falls back."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    dev = r.device
    if not r.is_cuda:
        raise ValueError("rwkv6_scan_cuda: r must lie on a card")
    named = {"k": k, "v": v, "w": w, "u": u, "state0": state0,
             "out_state": out_state}
    for name, t in named.items():
        if t is not None and t.device != dev:
            raise ValueError(f"rwkv6_scan_cuda: {name} on {t.device}, r on "
                             f"{dev}")
    if r.dtype not in _DTYPE_CODES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"rwkv6_scan_cuda: dtypes r={r.dtype} k={k.dtype} "
                        f"v={v.dtype}; want one of float32/bfloat16 for all "
                        "three")
    for name in ("w", "u", "state0", "out_state"):
        t = named[name]
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"rwkv6_scan_cuda: {name} is {t.dtype}, want "
                            "float32")
    state_shape = (B, H, K, V)
    if (k.shape != r.shape or w.shape != r.shape or v.shape[:3] != (B, S, H)
            or u.shape != (H, K)
            or (state0 is not None and state0.shape != state_shape)
            or (out_state is not None and out_state.shape != state_shape)):
        raise ValueError(
            f"rwkv6_scan_cuda: r/k/w {tuple(r.shape)}/{tuple(k.shape)}/"
            f"{tuple(w.shape)}, v {tuple(v.shape)}, u {tuple(u.shape)}, "
            f"state0 {None if state0 is None else tuple(state0.shape)}, "
            f"out_state "
            f"{None if out_state is None else tuple(out_state.shape)}; want "
            f"(B, S, H, K), (B, S, H, V), (H, K) and {state_shape}")
    if K not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan_cuda: key width K={K} not in "
                         f"{HEAD_DIMS}")
    if not 1 <= V <= MAX_V:
        raise ValueError(f"rwkv6_scan_cuda: value width V={V} not in "
                         f"[1, {MAX_V}]")
    if out_state is None:
        out_state = torch.empty(state_shape, dtype=torch.float32, device=dev)
    elif not out_state.is_contiguous():
        raise ValueError("rwkv6_scan_cuda: out_state must be contiguous (it "
                         "is written in place)")
    y = torch.empty(B, S, H, V, dtype=torch.float32, device=dev)
    r, k, v, w, u = (t.contiguous() for t in (r, k, v, w, u))
    if state0 is not None:
        state0 = state0.contiguous()
    lib = build.library()
    if tensor_core_route(r, v):
        r, k, v, w = (_aligned(t) for t in (r, k, v, w))
        ws = torch.empty(workspace_elems(B, S, H), dtype=torch.float32,
                         device=dev)
        dec = ws[B * H * -(-S // TC_CHUNK) * TC_WIDTH * TC_WIDTH:]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            build.check(lib.rwkv6_scan_tc_launch(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), None if state0 is None else state0.data_ptr(),
                y.data_ptr(), out_state.data_ptr(), ws.data_ptr(),
                dec.data_ptr(), B, S, H, _DTYPE_CODES[r.dtype], stream),
                "rwkv6_scan (tensor cores)")
        return y, out_state
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(lib.rwkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if state0 is None else state0.data_ptr(),
            y.data_ptr(), out_state.data_ptr(), B, S, H, K, V,
            _DTYPE_CODES[r.dtype], stream), "rwkv6_scan")
    return y, out_state


BWD_CHUNK = 32          # the CUDA-core backward's stored-state interval
BWD_MAX_V = 64          # value columns the backward takes


def backward_tensor_core_route(r, v) -> bool:
    """True when B4's backward of the call of ``r`` (B, S, H, K) and ``v``
    (B, S, H, V) runs chunk-parallel on the tensor cores: the forward's
    rule, K = V = 64 and S at least one chunk, float32 and bf16 r/k/v
    alike.  Reads shapes only."""
    return tensor_core_route(r, v)


def bwd_workspace_elems(B: int, S: int, H: int) -> int:
    """float32 elements of the backward's tensor-core workspace: each
    chunk's 64 x 64 entry state and the 64 x 64 gradient at its end, and
    its 64 decays, per (batch, head)."""
    nc = -(-S // TC_CHUNK)
    return B * H * nc * (2 * TC_WIDTH * TC_WIDTH + TC_WIDTH)


def rwkv6_scan_bwd_cuda(r, k, v, w, u, state0, dy, dsT=None, *,
                        tensor_cores=None):
    """Launch B4's backward on ``r``'s card: the gradients ``(dr, dk, dv,
    dw, du, dstate0)`` of :func:`rwkv6_scan_cuda`'s call on the same inputs
    from y's gradient ``dy`` and the final state's ``dsT`` (None: zero),
    all float32 (``dstate0`` None when ``state0`` is).  K is one of
    :data:`HEAD_DIMS`, V at most :data:`BWD_MAX_V`; S at least 1.

    Two routes.  :func:`backward_tensor_core_route` (K = V = 64, from one
    chunk of steps: every rwkv6-3b training call) runs chunk-parallel on
    the tensor cores over a float32 workspace of every chunk's entry state
    and end gradient; the rest runs one block per (batch, head) that stores
    the state every :data:`BWD_CHUNK` steps and recomputes the others, on
    CUDA cores.  ``tensor_cores`` None follows the rule; False takes the
    CUDA-core route at any shape (to time the two routes side by side);
    True raises where the rule does not hold.  ``du``, a sum over the batch
    rows, sums per-block partials in a fixed order in a last launch: the
    same bits every run.  A call on either route that fails to build or
    launch raises and never runs the other.  Raises on anything else;
    never falls back."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    dev = r.device
    if not r.is_cuda:
        raise ValueError("rwkv6_scan_bwd_cuda: r must lie on a card")
    for name, t in (("k", k), ("v", v), ("w", w), ("u", u), ("dy", dy),
                    ("state0", state0), ("dsT", dsT)):
        if t is not None and t.device != dev:
            raise ValueError(f"rwkv6_scan_bwd_cuda: {name} on {t.device}, "
                             f"r on {dev}")
    if r.dtype not in _DTYPE_CODES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"rwkv6_scan_bwd_cuda: dtypes r={r.dtype} "
                        f"k={k.dtype} v={v.dtype}; want one of "
                        "float32/bfloat16 for all three")
    for name, t in (("w", w), ("u", u), ("dy", dy), ("state0", state0),
                    ("dsT", dsT)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"rwkv6_scan_bwd_cuda: {name} is {t.dtype}, "
                            "want float32")
    state_shape = (B, H, K, V)
    if (k.shape != r.shape or w.shape != r.shape or v.shape[:3] != (B, S, H)
            or u.shape != (H, K) or dy.shape != v.shape
            or any(t is not None and t.shape != state_shape
                   for t in (state0, dsT))):
        raise ValueError(f"rwkv6_scan_bwd_cuda: r/k/w {tuple(r.shape)}, v "
                         f"{tuple(v.shape)}, u {tuple(u.shape)}, dy "
                         f"{tuple(dy.shape)}; want (B, S, H, K), (B, S, H, "
                         f"V), (H, K), y's shape and states {state_shape}")
    if K not in HEAD_DIMS or not 1 <= V <= BWD_MAX_V:
        raise ValueError(f"rwkv6_scan_bwd_cuda: K={K} not in {HEAD_DIMS} or "
                         f"V={V} not in [1, {BWD_MAX_V}]")
    tc = backward_tensor_core_route(r, v)
    if tensor_cores and not tc:
        raise ValueError(f"rwkv6_scan_bwd_cuda: no tensor-core route at "
                         f"S={S} K={K} V={V} (want K = V = {TC_WIDTH}, S >= "
                         f"{TC_CHUNK})")
    tc = tc if tensor_cores is None else bool(tensor_cores)
    f32 = dict(dtype=torch.float32, device=dev)
    dr, dk, dw = (torch.empty(B, S, H, K, **f32) for _ in range(3))
    dv = torch.empty(B, S, H, V, **f32)
    du = torch.empty(H, K, **f32)
    ds0 = None if state0 is None else torch.empty(state_shape, **f32)
    r, k, v, w, u, dy = (t.contiguous() for t in (r, k, v, w, u, dy))
    state0, dsT = (None if t is None else t.contiguous()
                   for t in (state0, dsT))
    ptr = (lambda t: None if t is None else t.data_ptr())
    lib = build.library()
    if tc:
        r, k, v, w, dy = (_aligned(t) for t in (r, k, v, w, dy))
        du_part = torch.empty(B * -(-S // TC_CHUNK) * H * K, **f32)
        ws = torch.empty(bwd_workspace_elems(B, S, H), **f32)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            build.check(lib.rwkv6_scan_bwd_tc_launch(
                r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), ptr(state0), dy.data_ptr(), ptr(dsT),
                dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                du_part.data_ptr(), du.data_ptr(), ptr(ds0), ws.data_ptr(),
                B, S, H, _DTYPE_CODES[r.dtype], stream),
                "rwkv6_scan_bwd (tensor cores)")
        return dr, dk, dv, dw, du, ds0
    du_part = torch.empty(B, H, K, **f32)
    ws = torch.empty(B * H * -(-S // BWD_CHUNK) * K * V, **f32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(lib.rwkv6_scan_bwd_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), ptr(state0), dy.data_ptr(), ptr(dsT),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
            du_part.data_ptr(), du.data_ptr(), ptr(ds0), ws.data_ptr(), B, S,
            H, K, V, _DTYPE_CODES[r.dtype], stream), "rwkv6_scan_bwd")
    return dr, dk, dv, dw, du, ds0
