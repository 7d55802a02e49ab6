"""The Mamba-2 SSD scan: the CUDA kernel's launcher and its plain PyTorch
version.

For every batch row and head, with an f32 N x P state ``S`` and one B/C
group shared by the heads::

    S_t = exp(la_t) S_{t-1} + B_t (outer) xdt_t        y_t = C_t . S_t

over xdt ``(B, S, H, P)``, la ``(B, S, H)`` (the log of each step's decay),
B and C ``(B, S, N)`` and an initial state ``(B, H, N, P)`` (zeros when
None).  Returns y ``(B, S, H, P)`` float32 and the final state
``(B, H, N, P)`` float32.  Every Mamba-2 layer runs it, prefill and decode
alike.

The kernel (``csrc/ssd_scan.cu``) replaces the TPU kernel
``repro/kernels/ssd_scan.py:ssd_scan`` and, like it, computes the chunked
dual form; its source note says what bounds it on Hopper and how the
design answers that.  Unlike the TPU wrapper it takes any sequence length,
not only multiples of its chunk.  It has two routes
(:func:`tensor_core_route`, from shapes and dtypes only): N = P = 64 with
bf16 B and C and at least one chunk of steps (every zamba2-7b prefill) run
on the tensor cores, in parallel over segments of TC_SEG chunks, two
launches over a float32 workspace the wrapper allocates; the rest (float32
B/C, other widths, short prompts, every decode step) runs one block per
(batch, head) that loops over the chunks on CUDA cores.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

STATE_DIMS = (4, 8, 16, 32, 64)    # the state widths N the kernel is built for
HEAD_DIMS = (8, 16, 32, 64)        # the head widths P
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
TC_CHUNK, TC_SUB = 64, 16         # the tensor-core route's chunk, sub-chunk
TC_SEG = 4                         # ... chunks a segment
TC_WIDTH = 64                      # ... and its N = P


def tensor_core_route(xdt, Bm) -> bool:
    """True when the kernel runs the call of ``xdt`` (B, S, H, P) and
    ``Bm`` (B, S, N) on the tensor cores: N = P = 64, B and C in bf16
    (exact in the tensor cores; float32 B/C would need both operands split
    in every product), S at least one chunk.  Reads shapes and dtypes
    only, so a CUDA graph can hold the call."""
    return (xdt.shape[-1] == TC_WIDTH and Bm.shape[-1] == TC_WIDTH
            and Bm.dtype == torch.bfloat16 and xdt.shape[1] >= TC_CHUNK)


def segments(S: int) -> int:
    """Segments of TC_SEG chunks of TC_CHUNK steps that cover S steps."""
    return -(-S // (TC_CHUNK * TC_SEG))


def workspace_elems(B: int, S: int, H: int) -> int:
    """float32 elements of the tensor-core route's workspace, per (batch,
    head): the initial state and each segment's 64 x 64 state
    contribution, then each segment's decay."""
    nseg = segments(S)
    return B * H * ((nseg + 1) * TC_WIDTH * TC_WIDTH + nseg)


def _aligned(t):
    """``t`` (contiguous) itself when the kernel can copy it in 16-byte
    pieces, else an aligned copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssd_scan_plain(xdt, la, Bm, Cm, state0=None, out_state=None):
    """The recurrence step by step in float32: the CPU path and the
    kernel's oracle (``repro.kernels.ref.ssd_scan``).  With ``out_state``
    the final state is copied into it (it may be ``state0``) and
    returned."""
    B, S, H, P = xdt.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    st = torch.zeros(B, H, N, P, dtype=f32, device=xdt.device) \
        if state0 is None else state0.to(f32).clone()
    xf, lf, Bf, Cf = (t.to(f32) for t in (xdt, la, Bm, Cm))
    y = torch.empty(B, S, H, P, dtype=f32, device=xdt.device)
    for t in range(S):
        decay = torch.exp(lf[:, t])[:, :, None, None]           # (B, H, 1, 1)
        st = st * decay + Bf[:, t, None, :, None] * xf[:, t, :, None, :]
        y[:, t] = torch.einsum("bn,bhnp->bhp", Cf[:, t], st)
    if out_state is not None:
        out_state.copy_(st)
        st = out_state
    return y, st


def ssd_scan_cuda(xdt, la, Bm, Cm, state0=None, out_state=None):
    """Launch the SSD kernel on ``xdt``'s card (current stream).  Shapes as
    in :func:`ssd_scan_plain`; xdt, la, state0 and out_state are float32,
    Bm and Cm share one dtype (float32 or bfloat16, widened in the kernel);
    N is one of 4, 8, 16, 32, 64 and P one of 8, 16, 32, 64.
    ``out_state`` (contiguous) receives the final state in place and may be
    ``state0``.  The route follows :func:`tensor_core_route`; a call on
    either route that fails to build or launch raises and never runs the
    other.  Raises on anything else; never falls back."""
    B, S, H, P = xdt.shape
    N = Bm.shape[-1]
    dev = xdt.device
    if not xdt.is_cuda:
        raise ValueError("ssd_scan_cuda: xdt must lie on a card")
    named = {"la": la, "Bm": Bm, "Cm": Cm, "state0": state0,
             "out_state": out_state}
    for name, t in named.items():
        if t is not None and t.device != dev:
            raise ValueError(f"ssd_scan_cuda: {name} on {t.device}, xdt on "
                             f"{dev}")
    for name, t in (("xdt", xdt), ("la", la), ("state0", state0),
                    ("out_state", out_state)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"ssd_scan_cuda: {name} is {t.dtype}, want "
                            "float32")
    if Bm.dtype not in _DTYPE_CODES or Cm.dtype != Bm.dtype:
        raise TypeError(f"ssd_scan_cuda: dtypes Bm={Bm.dtype} Cm={Cm.dtype}; "
                        "want one of float32/bfloat16 for both")
    state_shape = (B, H, N, P)
    if (la.shape != (B, S, H) or Bm.shape != (B, S, N)
            or Cm.shape != (B, S, N)
            or (state0 is not None and state0.shape != state_shape)
            or (out_state is not None and out_state.shape != state_shape)):
        raise ValueError(
            f"ssd_scan_cuda: xdt {tuple(xdt.shape)}, la {tuple(la.shape)}, "
            f"Bm/Cm {tuple(Bm.shape)}/{tuple(Cm.shape)}, state0 "
            f"{None if state0 is None else tuple(state0.shape)}, out_state "
            f"{None if out_state is None else tuple(out_state.shape)}; want "
            f"(B, S, H, P), (B, S, H), (B, S, N) and {state_shape}")
    if N not in STATE_DIMS:
        raise ValueError(f"ssd_scan_cuda: state width N={N} not in "
                         f"{STATE_DIMS}")
    if P not in HEAD_DIMS:
        raise ValueError(f"ssd_scan_cuda: head width P={P} not in "
                         f"{HEAD_DIMS}")
    if out_state is None:
        out_state = torch.empty(state_shape, dtype=torch.float32, device=dev)
    elif not out_state.is_contiguous():
        raise ValueError("ssd_scan_cuda: out_state must be contiguous (it "
                         "is written in place)")
    y = torch.empty(B, S, H, P, dtype=torch.float32, device=dev)
    xdt, la, Bm, Cm = (t.contiguous() for t in (xdt, la, Bm, Cm))
    if state0 is not None:
        state0 = state0.contiguous()
    lib = build.library()
    if tensor_core_route(xdt, Bm):
        xdt, Bm, Cm = (_aligned(t) for t in (xdt, Bm, Cm))
        if state0 is not None:
            state0 = _aligned(state0)
        # the kernel writes the final state in 16-byte pieces
        final = out_state if out_state.data_ptr() % 16 == 0 \
            else torch.empty(state_shape, dtype=torch.float32, device=dev)
        ws = torch.empty(workspace_elems(B, S, H), dtype=torch.float32,
                         device=dev)
        dec = ws[B * H * (segments(S) + 1) * TC_WIDTH * TC_WIDTH:]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            build.check(lib.ssd_scan_tc_launch(
                xdt.data_ptr(), la.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                None if state0 is None else state0.data_ptr(), y.data_ptr(),
                final.data_ptr(), ws.data_ptr(), dec.data_ptr(), B, S, H,
                stream), "ssd_scan (tensor cores)")
        if final is not out_state:
            out_state.copy_(final)
        return y, out_state
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(lib.ssd_scan_launch(
            xdt.data_ptr(), la.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            None if state0 is None else state0.data_ptr(), y.data_ptr(),
            out_state.data_ptr(), B, S, H, N, P, _DTYPE_CODES[Bm.dtype],
            stream), "ssd_scan")
    return y, out_state


BWD_CHUNK = 32          # the backward's stored-state interval (steps)
BWD_MAX_P = 64          # head columns the backward takes


def ssd_scan_bwd_cuda(xdt, la, Bm, Cm, state0, dy, dsT=None):
    """Launch B5's backward on ``xdt``'s card: the gradients ``(dxdt, dla,
    dBm, dCm, dstate0)`` of :func:`ssd_scan_cuda`'s call on the same inputs
    from y's gradient ``dy`` and the final state's ``dsT`` (None: zero):
    dxdt, dla and dstate0 float32 (``dstate0`` None when ``state0`` is),
    dBm and dCm in Bm's dtype.  N is one of :data:`STATE_DIMS`, P at most
    :data:`BWD_MAX_P`; S at least 1.  The kernel stores the state at the
    start of every :data:`BWD_CHUNK` steps in a float32 workspace and
    recomputes the rest; dBm and dCm, sums over the heads, are each head's
    terms summed in head order by a second launch: the same bits every
    run.  Raises on anything else; never falls back."""
    B, S, H, P = xdt.shape
    N = Bm.shape[-1]
    dev = xdt.device
    if not xdt.is_cuda:
        raise ValueError("ssd_scan_bwd_cuda: xdt must lie on a card")
    for name, t in (("la", la), ("Bm", Bm), ("Cm", Cm), ("dy", dy),
                    ("state0", state0), ("dsT", dsT)):
        if t is not None and t.device != dev:
            raise ValueError(f"ssd_scan_bwd_cuda: {name} on {t.device}, xdt "
                             f"on {dev}")
    for name, t in (("xdt", xdt), ("la", la), ("dy", dy), ("state0", state0),
                    ("dsT", dsT)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"ssd_scan_bwd_cuda: {name} is {t.dtype}, want "
                            "float32")
    if Bm.dtype not in _DTYPE_CODES or Cm.dtype != Bm.dtype:
        raise TypeError(f"ssd_scan_bwd_cuda: dtypes Bm={Bm.dtype} "
                        f"Cm={Cm.dtype}; want one of float32/bfloat16 for "
                        "both")
    state_shape = (B, H, N, P)
    if (la.shape != (B, S, H) or Bm.shape != (B, S, N)
            or Cm.shape != (B, S, N) or dy.shape != xdt.shape
            or any(t is not None and t.shape != state_shape
                   for t in (state0, dsT))):
        raise ValueError(f"ssd_scan_bwd_cuda: xdt {tuple(xdt.shape)}, la "
                         f"{tuple(la.shape)}, Bm/Cm {tuple(Bm.shape)}/"
                         f"{tuple(Cm.shape)}, dy {tuple(dy.shape)}; want "
                         "(B, S, H, P), (B, S, H), (B, S, N), y's shape and "
                         f"states {state_shape}")
    if N not in STATE_DIMS or not 1 <= P <= BWD_MAX_P:
        raise ValueError(f"ssd_scan_bwd_cuda: N={N} not in {STATE_DIMS} or "
                         f"P={P} not in [1, {BWD_MAX_P}]")
    f32 = dict(dtype=torch.float32, device=dev)
    dxdt = torch.empty(B, S, H, P, **f32)
    dla = torch.empty(B, S, H, **f32)
    dB, dC = torch.empty_like(Bm), torch.empty_like(Cm)
    ds0 = None if state0 is None else torch.empty(state_shape, **f32)
    xdt, la, Bm, Cm, dy = (t.contiguous() for t in (xdt, la, Bm, Cm, dy))
    state0, dsT = (None if t is None else t.contiguous()
                   for t in (state0, dsT))
    dB, dC = dB.contiguous(), dC.contiguous()
    db_part, dc_part = (torch.empty(B, S, H, N, **f32) for _ in range(2))
    ws = torch.empty(B * H * -(-S // BWD_CHUNK) * N * P, **f32)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(build.library().ssd_scan_bwd_launch(
            xdt.data_ptr(), la.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            ptr(state0), dy.data_ptr(), ptr(dsT), dxdt.data_ptr(),
            dla.data_ptr(), dB.data_ptr(), dC.data_ptr(), ptr(ds0),
            db_part.data_ptr(), dc_part.data_ptr(), ws.data_ptr(), B, S, H, N,
            P, _DTYPE_CODES[Bm.dtype], stream), "ssd_scan_bwd")
    return dxdt, dla, dB, dC, ds0
