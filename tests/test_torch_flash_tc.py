"""CPU mirrors of flash attention's tensor-core routes (B3,
``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``), held
against the plain version and autograd through it, and the route rules.

A mirror is a test-only torch function that does its kernel's arithmetic
step by step in the kernel's tiles: products of bf16 values exact and
summed in float32 (the wgmma accumulator), the softmax in float32 with
exp2 and the scale's log2 e folded in, every rounding to bf16 where the
kernel rounds (torch's float -> bf16 cast rounds to nearest even, as
``__floats2bfloat162_rn`` does).  The CUDA kernels cannot run here; the
mirrors show that the algorithm meets the card's limits before a card
sees it:

* the D 256 forward: 64-key tiles, P entering the PV product as a bf16
  pair hi + lo, against the plain version at the forward's bf16 limit
  (4e-3, ``TOL`` of ``tests/test_torch_gpu.py``);
* the backward at D 64, 128 and 256: the log-sum-exp from the forward
  mirror, delta = rowsum(dO * O), key tiles for dq and query tiles over
  the KV head's query heads for dk and dv (64 rows, 32 at D 256, where the
  kernel's shared memory holds 3 stages of 32-row tiles), P and dS each
  rounded to bf16 once before their products, against autograd through
  the plain version in float32 at the backward's bf16 limit (2e-2 of the
  largest magnitude, ``BWD_ATTN_REL``).  At D 256 the kernel computes dk
  and dv in blocks of their own over the same tiles: the mirror's dk and
  dv sums are already apart, so the split moves no rounding.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain

FWD_TOL = 4e-3      # the card's limits (tests/test_torch_gpu.py)
BWD_REL = 2e-2
LOG2E = 1.4426950408889634
F32, BF16 = torch.float32, torch.bfloat16


def bf16(x):
    """Round float32 to bf16 and back, to nearest even."""
    return x.to(BF16).to(F32)


def _heads(x, G):
    """(B, S, H, D) -> (B, H * G, S, D) float32, each head repeated for its
    G query heads."""
    return x.to(F32).repeat_interleave(G, dim=2).permute(0, 2, 1, 3)


def _visible(rows, keys, S_k, causal, window):
    """(len(rows), len(keys)) mask: key < S_k, causal and window."""
    r, c = rows[:, None], keys[None, :]
    ok = c < S_k
    if causal:
        ok = ok & (c <= r)
    if window is not None:
        ok = ok & (r - c < window)
    return ok


def forward_mirror(q, k, v, *, causal, window, bn):
    """The tensor-core forward's arithmetic: ``bn``-key tiles (128 at D 64
    and 128, 64 at D 256), the online softmax on exp2 with the scale's
    log2 e folded into one multiply-add, P as bf16 hi + lo into PV.
    Returns (out bf16 (B, Sq, Hq, D), lse in log2 units float32 (B, Hq,
    Sq))."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    sl2 = D ** -0.5 * LOG2E
    qf = q.to(F32).permute(0, 2, 1, 3)
    kf, vf = _heads(k, G), _heads(v, G)
    rows = torch.arange(Sq)
    m = torch.full((B, Hq, Sq), -1e30)
    l = torch.zeros(B, Hq, Sq)
    o = torch.zeros(B, Hq, Sq, D)
    for k0 in range(0, Sk, bn):
        keys = torch.arange(k0, k0 + bn)
        s = qf @ kf[:, :, k0:k0 + bn].transpose(-1, -2)
        kt = min(bn, Sk - k0)
        s = torch.cat([s, torch.zeros(B, Hq, Sq, bn - kt)], -1)
        ok = _visible(rows, keys, Sk, causal, window)
        s = torch.where(ok, s, -math.inf)
        mx = torch.maximum(m, s.amax(-1))
        corr = torch.exp2((m - mx) * sl2)
        p = torch.exp2(s * sl2 - (mx * sl2)[..., None])
        l = l * corr + p.sum(-1)
        hi = bf16(p)
        lo = bf16(p - hi)
        vt = torch.cat([vf[:, :, k0:k0 + bn],
                        torch.zeros(B, Hq, bn - kt, D)], 2)
        o = o * corr[..., None] + (hi @ vt + lo @ vt)
        m = mx
    out = o / torch.clamp(l, min=1e-30)[..., None]
    lse = torch.where(l > 0, m * sl2 + torch.log2(l), torch.tensor(1e30))
    return out.permute(0, 2, 1, 3).to(BF16), lse


def backward_mirror(q, k, v, out, dout, lse, *, causal, window, tile=64):
    """The tensor-core backward's arithmetic (``Sq == Sk``): delta =
    rowsum(dO * O) in float32; the dq kernel over ``tile``-key tiles and
    the dk/dv kernel over ``tile``-query tiles, each recomputing S and dP,
    P = exp2(s scale log2 e - lse) zeroed where masked, dS = P (dP -
    delta), P and dS rounded to bf16 once before their products; dk and
    dv summed over the KV head's query heads.  Returns (dq, dk, dv) bf16."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5
    sl2 = scale * LOG2E
    qf, gf, of = (t.to(F32).permute(0, 2, 1, 3) for t in (q, dout, out))
    kf, vf = _heads(k, G), _heads(v, G)
    delta = (gf * of).sum(-1)
    pos = torch.arange(S)
    dq = torch.zeros(B, Hq, S, D)
    for k0 in range(0, S, tile):
        kt, vt = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        ok = _visible(pos, pos[k0:k0 + tile], S, causal, window)
        p = torch.where(ok, torch.exp2(qf @ kt.transpose(-1, -2) * sl2
                                       - lse[..., None]), 0.0)
        ds = p * (gf @ vt.transpose(-1, -2) - delta[..., None])
        dq = dq + bf16(ds) @ kt
    dk = torch.zeros(B, Hq, S, D)
    dv = torch.zeros(B, Hq, S, D)
    for q0 in range(0, S, tile):
        qt, gt = qf[:, :, q0:q0 + tile], gf[:, :, q0:q0 + tile]
        ok = _visible(pos[q0:q0 + tile], pos, S, causal, window).T
        pt = torch.where(ok, torch.exp2(kf @ qt.transpose(-1, -2) * sl2
                                        - lse[:, :, None, q0:q0 + tile]),
                         0.0)
        dst = pt * (vf @ gt.transpose(-1, -2)
                    - delta[:, :, None, q0:q0 + tile])
        dv = dv + bf16(pt) @ gt
        dk = dk + bf16(dst) @ qt

    def kv(x):
        return x.reshape(B, Hkv, G, S, D).sum(2).permute(0, 2, 1, 3)

    return ((dq * scale).permute(0, 2, 1, 3).to(BF16),
            (kv(dk) * scale).to(BF16), kv(dv).to(BF16))


def _inputs(seed, B, S, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    q, g = (torch.from_numpy(rng.standard_normal((B, S, Hq, D),
                                                 dtype=np.float32)).to(BF16)
            for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, S, Hkv, D),
                                                 dtype=np.float32)).to(BF16)
            for _ in range(2))
    return q, k, v, g


def _rel(got, want):
    """max |d| over max(1, max |want|), chip_smoke's grad_gap."""
    err = (got.float() - want.float()).abs().max().item()
    return err / max(1.0, want.float().abs().max().item())


def _plain_grads(q, k, v, g, causal, window):
    leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention_plain(*leaves, causal=causal, window=window)
    return torch.autograd.grad(out, leaves, g.float())


def _tiles(D):
    """The tensor-core kernels' tiles at D: (the forward's keys a tile,
    the backward's streamed rows a tile)."""
    return (64, 32) if D == 256 else (128, 64)


# (B, S, Hq, Hkv, D, causal, window); D 256: causal at a ragged S, gemma3's
# window (64 here, several tiles wide), non-causal at G 2
BWD_MIRROR_CASES = [(1, 512, 2, 1, 128, True, None),
                    (1, 300, 4, 2, 64, True, 100),
                    (1, 256, 4, 2, 64, False, None),
                    (1, 300, 2, 1, 256, True, None),
                    (1, 200, 2, 1, 256, True, 64),
                    (1, 130, 4, 2, 256, False, None)]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,window", BWD_MIRROR_CASES)
def test_backward_mirror_meets_the_bf16_limit(B, S, Hq, Hkv, D, causal,
                                              window):
    q, k, v, g = _inputs(0, B, S, Hq, Hkv, D)
    bn, tile = _tiles(D)
    out, lse = forward_mirror(q, k, v, causal=causal, window=window, bn=bn)
    got = backward_mirror(q, k, v, out, g, lse, causal=causal,
                          window=window, tile=tile)
    want = _plain_grads(q, k, v, g, causal, window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _rel(a, b) < BWD_REL / 2, (name, _rel(a, b))


def test_forward_mirror_lse_is_the_rows_logsumexp():
    q, k, v, _ = _inputs(1, 1, 200, 4, 2, 64)
    out, lse = forward_mirror(q, k, v, causal=True, window=48, bn=128)
    D = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float().repeat_interleave(2, dim=2)) * D ** -0.5
    pos = torch.arange(200)
    s = torch.where(_visible(pos, pos, 200, True, 48), s, -math.inf)
    want = torch.logsumexp(s, -1) * LOG2E
    assert torch.allclose(lse, want, rtol=1e-5, atol=1e-5)
    assert (out.float() - flash_attention_plain(
        q, k, v, causal=True, window=48).float()).abs().max() <= FWD_TOL


# (B, Sq, Sk, Hq, Hkv, causal, window) at D 256
FWD256_MIRROR_CASES = [(1, 300, 300, 2, 1, True, None),
                       (1, 260, 260, 2, 1, True, 64),
                       (1, 130, 90, 2, 2, False, None)]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,causal,window", FWD256_MIRROR_CASES)
def test_d256_forward_mirror_meets_the_bf16_limit(B, Sq, Sk, Hq, Hkv, causal,
                                                  window):
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((B, Sq, Hq, 256),
                                             dtype=np.float32)).to(BF16)
    k, v = (torch.from_numpy(rng.standard_normal((B, Sk, Hkv, 256),
                                                 dtype=np.float32)).to(BF16)
            for _ in range(2))
    got, _ = forward_mirror(q, k, v, causal=causal, window=window, bn=64)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    assert torch.allclose(got.float(), want.float(), rtol=FWD_TOL,
                          atol=FWD_TOL)


def _t(dtype, D, S=8):
    return torch.zeros(1, S, 2, D, dtype=dtype)


@pytest.mark.parametrize("dtype,D,fwd,bwd", [
    (BF16, 64, True, True), (BF16, 128, True, True), (BF16, 256, True, True),
    (BF16, 16, False, False), (BF16, 32, False, False),
    (F32, 64, False, False), (F32, 128, False, False),
    (F32, 256, False, False)])
def test_route_rules(dtype, D, fwd, bwd):
    q = _t(dtype, D)
    assert FA.tensor_core_route(q) is fwd
    assert FA.backward_tensor_core_route(q) is bwd


def test_lse_rows_pad_to_the_forward_block():
    assert [FA.lse_rows(s) for s in (1, 128, 129, 2048, 2000)] == \
        [128, 128, 256, 2048, 2048]


def test_cpu_backward_counts_plain_and_no_backward_kernel():
    ops.reset_counts()
    q, k, v, g = _inputs(3, 1, 16, 2, 1, 64)
    leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=True)
    torch.autograd.grad(out, leaves, g.float())
    assert ops.COUNTS["flash_attention"].plain == 1
    assert ops.COUNTS["flash_attention_bwd"].kernel == 0
    assert ops.COUNTS["flash_attention_bwd_tc"].kernel == 0
