"""Public wrappers of the port's kernels, with launch counters.

A wrapper picks its route from where its input lies: a CUDA tensor goes to
the hand-written kernel (a build or launch failure raises; there is no
fallback), a CPU tensor to the kernel's plain PyTorch version.  Each
wrapper counts kernel launches and plain calls in :data:`COUNTS`, so a run
can show which route its main path took; :func:`reset_counts` zeroes them.
Eleven entries are sub-counts of a kernel's calls, not kernels of their
own (five of them the backward's, below): ``rmsnorm_add`` and
``rmsnorm_gated`` count the RMSNorm calls (each
one launch, all counted under ``rmsnorm``) of its fused variants, the
residual add and Mamba-2's SiLU gate, on either route;
``flash_attention_tc`` counts the flash-attention launches that took
the tensor-core route, ``paged_attention_mq_split`` the paged-attention
calls (float or int8 pages) split over more than one key range, each a
split launch and a combine launch, and ``rwkv6_scan_tc`` and
``ssd_scan_tc`` the scan calls that took the tensor-core route: three
launches for the wkv (chunk states, the pass over them, outputs), two for
the SSD (segment states, outputs).
The counts are bumped under a lock: the dense path's prefills run on the
prefill farm's worker threads.

Training: when autograd needs a gradient through a call (grad mode on and
an input that requires one), RMSNorm and its two fused variants, flash
attention and the two scans run as ``torch.autograd.Function``s on a card,
whose backward is a kernel too: ``rmsnorm_bwd`` counts B2's backward
launches (``rmsnorm_add_bwd`` the fused add's among them,
``rmsnorm_gated_bwd`` the gated norm's), ``flash_attention_bwd`` B3's
backward calls and its sub-count ``flash_attention_bwd_tc`` those on the
tensor cores (bf16 at D 64 and 128, and 112 padded to 128: three launches,
delta = rowsum(dO * O), dq, then dk and dv, reading the log-sum-exp the
forward wrote; the CUDA-core route two: dq with the rows' log-sum-exp,
then dk and dv), ``rwkv6_scan_bwd`` B4's and ``ssd_scan_bwd`` B5's
calls, and their sub-counts ``rwkv6_scan_bwd_tc`` / ``ssd_scan_bwd_tc``
those on the chunk-parallel tensor-core route (the forward's rule: six
launches for the wkv, the chunks' state and gradient contributions, the
passes up and down the chunks, dr/dk/dv/dw with du's partials, du; five
for the SSD, the contributions, the two passes, the gradients, dB and dC
summed over the head groups); the CUDA-core route two each (the
gradients, then du summed over the batch rows, or dB and dC over the
heads).  Their forward launches
count as serving's do; a scan under autograd takes no ``out_state`` (an
in-place write into a tensor autograd tracks).  On the CPU autograd
differentiates the plain versions.  Paged attention, which has no
backward, refuses a card call that needs a gradient (its caller, serving,
takes none); no gradient goes through a plain version on a card.  Without
a gradient to take, the launches, routes and counts are those of serving.
"""
from __future__ import annotations

import dataclasses
import threading

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import rwkv6_scan as _rw
from repro_torch.kernels import ssd_scan as _ssd


@dataclasses.dataclass
class LaunchCount:
    """Calls of one wrapper: kernel launches and plain-version calls."""
    kernel: int = 0
    plain: int = 0


COUNTS = {"rmsnorm": LaunchCount(), "paged_attention_mq": LaunchCount(),
          "paged_attention_mq_int8": LaunchCount(),
          "flash_attention": LaunchCount(), "rwkv6_scan": LaunchCount(),
          "ssd_scan": LaunchCount(),
          # sub-counts of RMSNorm's, the attention kernels' and the scans'
          # calls
          "rmsnorm_add": LaunchCount(), "rmsnorm_gated": LaunchCount(),
          "flash_attention_tc": LaunchCount(),
          "paged_attention_mq_split": LaunchCount(),
          "rwkv6_scan_tc": LaunchCount(), "ssd_scan_tc": LaunchCount(),
          # the backward kernels, and the fused variants' sub-counts of B2's
          "rmsnorm_bwd": LaunchCount(), "rmsnorm_add_bwd": LaunchCount(),
          "rmsnorm_gated_bwd": LaunchCount(),
          "flash_attention_bwd": LaunchCount(),
          "flash_attention_bwd_tc": LaunchCount(),
          "rwkv6_scan_bwd": LaunchCount(), "ssd_scan_bwd": LaunchCount(),
          # the scan backwards' sub-counts
          "rwkv6_scan_bwd_tc": LaunchCount(),
          "ssd_scan_bwd_tc": LaunchCount()}
_count_lock = threading.Lock()


def reset_counts() -> None:
    """Zero every wrapper's counters."""
    with _count_lock:
        for c in COUNTS.values():
            c.kernel = c.plain = 0


def _count(*names: str, kernel: bool) -> None:
    with _count_lock:
        for name in names:
            if kernel:
                COUNTS[name].kernel += 1
            else:
                COUNTS[name].plain += 1


def _route(x, name: str) -> bool:
    """True for the kernel route (x on a card), False for the plain one."""
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise ValueError(f"{name}: no route for a tensor on {x.device}")
    return False


def _needs_grad(*tensors) -> bool:
    """Whether autograd takes a gradient through a call on ``tensors``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _no_backward(name: str, *tensors) -> None:
    """Refuse a card call that autograd would differentiate: the kernel
    has no backward (paged attention serves only)."""
    if _needs_grad(*tensors):
        raise NotImplementedError(
            f"{name}: the kernel has no backward (no training path calls "
            "it); no gradient goes through a plain version on a card")


def _no_out_state(name: str, out_state) -> None:
    """Refuse an in-place final state under autograd."""
    if out_state is not None:
        raise ValueError(f"{name}: no out_state under autograd (an in-place "
                         "write into a tensor autograd tracks)")


class _RMSNorm(torch.autograd.Function):
    """B2 on a card with its backward kernel."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        out = _rn.rmsnorm_cuda(x, scale, eps=eps)
        _count("rmsnorm", kernel=True)
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = _rn.rmsnorm_bwd_cuda(x, dy, None, scale, eps=ctx.eps)
        _count("rmsnorm_bwd", kernel=True)
        return dx, dscale, None


class _AddRMSNorm(torch.autograd.Function):
    """B2's fused residual add on a card with its backward kernel: the sum
    is always stored (the backward reads it), and its gradient, with the
    norm's, passes to both addends."""

    @staticmethod
    def forward(ctx, x, delta, scale, eps):
        s, out = _rn.add_rmsnorm_cuda(x, delta, scale, eps=eps,
                                      keep_sum=True)
        _count("rmsnorm", "rmsnorm_add", kernel=True)
        ctx.save_for_backward(s, scale)
        ctx.eps = eps
        ctx.set_materialize_grads(False)
        return s, out

    @staticmethod
    def backward(ctx, ds, dy):
        s, scale = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(s)
        dv, dscale = _rn.rmsnorm_bwd_cuda(s, dy, ds, scale, eps=ctx.eps)
        _count("rmsnorm_bwd", "rmsnorm_add_bwd", kernel=True)
        return dv, dv, dscale, None


class _FlashAttention(torch.autograd.Function):
    """B3 on a card with its backward kernels (any ``Sq``, ``Sk`` and
    query offset).  Where the backward takes the tensor cores the forward
    also writes each row's log-sum-exp, which the backward reads."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        tc_bwd = _fa.backward_tensor_core_route(q)
        res = _fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset, with_lse=tc_bwd)
        out, lse = res if tc_bwd else (res, None)
        _count("flash_attention", kernel=True)
        if _fa.tensor_core_route(q):
            _count("flash_attention_tc", kernel=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.q_offset = causal, window, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _fa.flash_attention_bwd_cuda(
            q, k, v, out, dout, causal=ctx.causal, window=ctx.window,
            q_offset=ctx.q_offset, lse=lse)
        _count("flash_attention_bwd", kernel=True)
        if lse is not None:
            _count("flash_attention_bwd_tc", kernel=True)
        return dq, dk, dv, None, None, None


class _GatedRMSNorm(torch.autograd.Function):
    """B2's gated variant on a card with its backward kernel (the gate's
    gradients in the same launch)."""

    @staticmethod
    def forward(ctx, y, z, scale, eps):
        out = _rn.gated_rmsnorm_cuda(y, z, scale, eps=eps)
        _count("rmsnorm", "rmsnorm_gated", kernel=True)
        ctx.save_for_backward(y, z, scale)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, dout):
        y, z, scale = ctx.saved_tensors
        dy, dz, dscale = _rn.gated_rmsnorm_bwd_cuda(y, z, dout, scale,
                                                    eps=ctx.eps)
        _count("rmsnorm_bwd", "rmsnorm_gated_bwd", kernel=True)
        return dy, dz, dscale, None


class _Rwkv6Scan(torch.autograd.Function):
    """B4 on a card with its backward kernel: ``(y, final state)``, both
    differentiable."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0):
        y, st = _rw.rwkv6_scan_cuda(r, k, v, w, u, state0)
        _count("rwkv6_scan", kernel=True)
        if _rw.tensor_core_route(r, v):
            _count("rwkv6_scan_tc", kernel=True)
        ctx.save_for_backward(r, k, v, w, u, state0)
        ctx.set_materialize_grads(False)
        return y, st

    @staticmethod
    def backward(ctx, dy, dsT):
        r, k, v, w, u, state0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        dr, dk, dv, dw, du, ds0 = _rw.rwkv6_scan_bwd_cuda(
            r, k, v, w, u, state0, dy, dsT)
        _count("rwkv6_scan_bwd", kernel=True)
        if _rw.backward_tensor_core_route(r, v):
            _count("rwkv6_scan_bwd_tc", kernel=True)
        return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw, du, ds0)


class _SsdScan(torch.autograd.Function):
    """B5 on a card with its backward kernel: ``(y, final state)``, both
    differentiable."""

    @staticmethod
    def forward(ctx, xdt, la, Bm, Cm, state0):
        y, st = _ssd.ssd_scan_cuda(xdt, la, Bm, Cm, state0)
        _count("ssd_scan", kernel=True)
        if _ssd.tensor_core_route(xdt, Bm):
            _count("ssd_scan_tc", kernel=True)
        ctx.save_for_backward(xdt, la, Bm, Cm, state0)
        ctx.set_materialize_grads(False)
        return y, st

    @staticmethod
    def backward(ctx, dy, dsT):
        xdt, la, Bm, Cm, state0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(xdt.shape, dtype=torch.float32,
                             device=xdt.device)
        dxdt, dla, dB, dC, ds0 = _ssd.ssd_scan_bwd_cuda(
            xdt, la, Bm, Cm, state0, dy, dsT)
        _count("ssd_scan_bwd", kernel=True)
        if _ssd.backward_tensor_core_route(xdt, Bm):
            _count("ssd_scan_bwd_tc", kernel=True)
        return dxdt, dla, dB, dC, ds0


def rmsnorm(x, scale, *, eps: float = 1e-6):
    """RMSNorm over the last axis of ``x`` with a ``(d,)`` scale."""
    if _route(x, "rmsnorm") and _needs_grad(x, scale):
        return _RMSNorm.apply(x, scale, eps)
    if _route(x, "rmsnorm"):
        out = _rn.rmsnorm_cuda(x, scale, eps=eps)
        _count("rmsnorm", kernel=True)
        return out
    _count("rmsnorm", kernel=False)
    return _rn.rmsnorm_plain(x, scale, eps=eps)


def add_rmsnorm(x, delta, scale, *, eps: float = 1e-6,
                keep_sum: bool = True):
    """The residual add fused into the next RMSNorm: ``(s, y)``, ``s = x +
    delta`` (bit for bit) and ``y`` the RMSNorm of ``s``; ``s`` is None,
    and the kernel does not store it, unless ``keep_sum`` (under autograd
    the kernel stores it for the backward all the same)."""
    if _route(x, "rmsnorm") and _needs_grad(x, delta, scale):
        s, out = _AddRMSNorm.apply(x, delta, scale, eps)
        return s if keep_sum else None, out
    if _route(x, "rmsnorm"):
        out = _rn.add_rmsnorm_cuda(x, delta, scale, eps=eps,
                                   keep_sum=keep_sum)
        _count("rmsnorm", "rmsnorm_add", kernel=True)
        return out
    _count("rmsnorm", "rmsnorm_add", kernel=False)
    return _rn.add_rmsnorm_plain(x, delta, scale, eps=eps, keep_sum=keep_sum)


def gated_rmsnorm(y, z, scale, *, eps: float = 1e-6):
    """Mamba-2's gated output norm, ``rmsnorm(y.to(z.dtype) * silu(z))``,
    in one kernel; y float32, the result in z's dtype.  Under autograd on
    a card the backward is a kernel too."""
    if _route(y, "rmsnorm") and _needs_grad(y, z, scale):
        return _GatedRMSNorm.apply(y, z, scale, eps)
    if _route(y, "rmsnorm"):
        out = _rn.gated_rmsnorm_cuda(y, z, scale, eps=eps)
        _count("rmsnorm", "rmsnorm_gated", kernel=True)
        return out
    _count("rmsnorm", "rmsnorm_gated", kernel=False)
    return _rn.gated_rmsnorm_plain(y, z, scale, eps=eps)


def paged_attention_mq(q, k_pages, v_pages, tables, lengths, k_scale=None,
                       v_scale=None):
    """Paged multi-query attention, (B, W, Hq, D) -> (B, W, Hq, D); see
    :mod:`repro_torch.kernels.paged_attention`.  With ``k_scale`` and
    ``v_scale`` the pages are int8, and the calls count under
    ``paged_attention_mq_int8``."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_attention_mq: pass both k_scale and v_scale "
                         "or neither")
    name = "paged_attention_mq" if k_scale is None \
        else "paged_attention_mq_int8"
    if _route(q, name):
        _no_backward(name, q, k_pages, v_pages)
        out = _pa.paged_attention_mq_cuda(q, k_pages, v_pages, tables, lengths,
                                          k_scale, v_scale)
        _count(name, kernel=True)
        if _pa.split_count(tables.shape[-1], k_pages.shape[1]) > 1:
            _count("paged_attention_mq_split", kernel=True)
        return out
    _count(name, kernel=False)
    return _pa.paged_attention_mq_plain(q, k_pages, v_pages, tables, lengths,
                                        k_scale, v_scale)


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    q_offset: int = 0):
    """Whole-sequence GQA, (B, Sq, Hq, D) x (B, Sk, Hkv, D) -> (B, Sq, Hq, D);
    ``window`` None for global attention; query row ``i`` at position
    ``q_offset + i``; see :mod:`repro_torch.kernels.flash_attention`.  Under
    autograd on a card the backward is a kernel too."""
    if _route(q, "flash_attention") and _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, q_offset)
    if _route(q, "flash_attention"):
        out = _fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset)
        _count("flash_attention", kernel=True)
        if _fa.tensor_core_route(q):
            _count("flash_attention_tc", kernel=True)
        return out
    _count("flash_attention", kernel=False)
    return _fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)


def rwkv6_scan(r, k, v, w, u, state0=None, *, out_state=None):
    """The RWKV-6 wkv recurrence, r/k/w (B, S, H, K), v (B, S, H, V) ->
    (y (B, S, H, V) float32, final state (B, H, K, V) float32); with
    ``out_state`` the final state lands there in place (it may be
    ``state0``; never under autograd); see
    :mod:`repro_torch.kernels.rwkv6_scan`.  Under autograd on a card the
    backward is a kernel too."""
    grad = _needs_grad(r, k, v, w, u, state0)
    if grad:
        _no_out_state("rwkv6_scan", out_state)
    if _route(r, "rwkv6_scan") and grad:
        return _Rwkv6Scan.apply(r, k, v, w, u, state0)
    if _route(r, "rwkv6_scan"):
        out = _rw.rwkv6_scan_cuda(r, k, v, w, u, state0, out_state)
        _count("rwkv6_scan", kernel=True)
        if _rw.tensor_core_route(r, v):
            _count("rwkv6_scan_tc", kernel=True)
        return out
    _count("rwkv6_scan", kernel=False)
    return _rw.rwkv6_scan_plain(r, k, v, w, u, state0, out_state)


def ssd_scan(xdt, la, Bm, Cm, state0=None, *, out_state=None):
    """The Mamba-2 SSD recurrence, xdt (B, S, H, P), la (B, S, H), Bm/Cm
    (B, S, N) -> (y (B, S, H, P) float32, final state (B, H, N, P)
    float32); with ``out_state`` the final state lands there in place (it
    may be ``state0``; never under autograd); see
    :mod:`repro_torch.kernels.ssd_scan`.  Under autograd on a card the
    backward is a kernel too."""
    grad = _needs_grad(xdt, la, Bm, Cm, state0)
    if grad:
        _no_out_state("ssd_scan", out_state)
    if _route(xdt, "ssd_scan") and grad:
        return _SsdScan.apply(xdt, la, Bm, Cm, state0)
    if _route(xdt, "ssd_scan"):
        out = _ssd.ssd_scan_cuda(xdt, la, Bm, Cm, state0, out_state)
        _count("ssd_scan", kernel=True)
        if _ssd.tensor_core_route(xdt, Bm):
            _count("ssd_scan_tc", kernel=True)
        return out
    _count("ssd_scan", kernel=False)
    return _ssd.ssd_scan_plain(xdt, la, Bm, Cm, state0, out_state)
