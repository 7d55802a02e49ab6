"""CPU mirrors of the chunk-parallel tensor-core routes of the two recurrent
scans, B4 (``csrc/rwkv6_scan.cu``, the RWKV-6 wkv) and B5
(``csrc/ssd_scan.cu``, the Mamba-2 SSD), held against the plain versions
(``rwkv6_scan_plain`` / ``ssd_scan_plain``) and the reference's oracles.

A mirror is a test-only torch function that does its kernel's arithmetic
step by step, in float32, in the kernel's order of decomposition: the
chunks and sub-chunks, each decay factor formed as the kernel forms it, the
3xTF32 split of every tensor-core product (TF32 rounding emulated by
rounding the float32 bit pattern to 10 mantissa bits, as ``cvt.rna.tf32``
does), the products of tf32 values exact and summed in float32, and the
sequential pass over the chunk states.  The CUDA kernels cannot run here;
the mirrors show that the algorithm meets the card's limits (RWKV_REL and
SSD_REL of ``tests/test_torch_gpu.py``) before a card sees it, in the cases
that are hard for it: the full-width decay range, exact zeros and
denormals in w, a length one step short of a chunk, on a chunk edge and
one past it, a ragged length, a nonzero initial state.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import rwkv6_scan as RW
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain
from repro_torch.kernels.ssd_scan import ssd_scan_plain

RWKV_REL = 1e-5     # the card's limits (tests/test_torch_gpu.py)
SSD_REL = 1e-5
F32 = torch.float32


# -- the tensor-core arithmetic ----------------------------------------------

def tf32(x):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero: ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(F32)


def split(x):
    """``x`` as hi + lo, both TF32: hi carries 11 significant bits, lo the
    next 11, so hi + lo is ``x`` to about 2^-22."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a, b):
    """``a @ b`` as the kernels' 3xTF32 products: lo.hi + hi.lo + hi.hi,
    each product of two TF32 values exact in float32 (the tensor core's
    accumulator), lo.lo dropped."""
    ah, al = split(a)
    bh, bl = split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm2(a, b):
    """``a @ b`` where ``a`` is exact in TF32 (bf16 values): two products."""
    assert torch.equal(tf32(a), a)
    bh, bl = split(b)
    return a @ bl + a @ bh


# -- B4: the wkv scan in chunks of L with sub-chunks of SUB --------------------

def rwkv6_mirror(r, k, v, w, u, state0=None):
    """The wkv kernel's tensor-core route (three launches) in float32.

    The product form: every decay is a product of w, never a log, so exact
    zeros and denormals in w need no care.  Inside a sub-chunk the pairs
    j < i take prod_{j<t<i} w_t directly, walking j down from i (CUDA
    cores); pairs across sub-chunks split the product at i's sub-chunk
    start b: (r_i prod_{b<=t<i} w_t) . (k_j prod_{j<t<b} w_t), both factors
    <= 1, a 3xTF32 product."""
    L, SUB = RW.TC_CHUNK, RW.TC_SUB
    B, S, H, K = r.shape
    V = v.shape[-1]
    nc = -(-S // L)
    pad = nc * L - S

    def chunks(t, fill):        # (B, S, H, C) -> (B, H, nc, L, C), padded
        t = t.to(F32)
        if pad:
            t = torch.cat([t, torch.full((B, pad, H, t.shape[-1]), fill)], 1)
        return t.view(B, nc, L, H, -1).permute(0, 3, 1, 2, 4)

    rc, kc, vc, wc = chunks(r, 0.0), chunks(k, 0.0), chunks(v, 0.0), \
        chunks(w, 1.0)
    ns = L // SUB
    sub = lambda t: t.reshape(B, H, nc, ns, SUB, -1)  # noqa: E731
    rs, ks, ws = sub(rc), sub(kc), sub(wc)
    # per sub-chunk and channel: q = r * prod_{b<=t<i} w (forward walk),
    # kE = k * prod_{j<t<end} w (backward walk), G = the sub-chunk's product
    q, kE = torch.empty_like(rs), torch.empty_like(ks)
    p = torch.ones_like(rs[..., 0, :])
    for t in range(SUB):
        q[..., t, :] = rs[..., t, :] * p
        p = p * ws[..., t, :]
    e = torch.ones_like(p)
    for t in reversed(range(SUB)):
        kE[..., t, :] = ks[..., t, :] * e
        e = e * ws[..., t, :]
    G = e                                             # (B, H, nc, ns, K)

    # launch 1: each chunk's state contribution and decay
    after = torch.ones_like(G)                        # prod_{u' > u} G_u'
    for s in reversed(range(ns - 1)):
        after[..., s, :] = after[..., s + 1, :] * G[..., s + 1, :]
    khat = (kE * after[..., None, :]).reshape(B, H, nc, L, K)
    dS = mm3(khat.transpose(-1, -2), vc)              # (B, H, nc, K, V)
    D = G[..., 0, :] * after[..., 0, :]               # (B, H, nc, K)

    # launch 2: the chunk-entry states, in order
    st = torch.zeros(B, H, K, V) if state0 is None else state0.to(F32).clone()
    entry = []
    for c in range(nc):
        entry.append(st)
        st = D[:, :, c, :, None] * st + dS[:, :, c]
    Sc = torch.stack(entry, 2)                        # (B, H, nc, K, V)

    # launch 3: the outputs
    A = torch.zeros(B, H, nc, L, L)
    for s in range(ns):
        b = s * SUB
        # pairs inside the sub-chunk: walk j down from i - 1 with the
        # running product p = prod_{j<t<i} w_t; the bonus on the diagonal
        ri = rs[..., s, :, :]                          # (B, H, nc, SUB, K)
        acc = torch.zeros(B, H, nc, SUB, SUB)
        pw = torch.zeros_like(ri)
        rows = torch.arange(SUB)[:, None]
        for jj in reversed(range(SUB)):
            pw = torch.where(rows == jj + 1, torch.ones_like(pw), pw)
            acc[..., jj] = (ri * ks[..., s, jj, None, :] * pw).sum(-1)
            pw = pw * ws[..., s, jj, None, :]
        acc = torch.tril(acc, -1)
        bonus = (ri * u.to(F32)[None, :, None, None, :]
                 * ks[..., s, :, :]).sum(-1)
        A[..., b:b + SUB, b:b + SUB] = acc + torch.diag_embed(bonus)
        # pairs across sub-chunks: q_s . (kE_t prod_{t<u'<s} G_u')^T
        f = torch.ones_like(G[..., 0, :])
        for t in reversed(range(s)):
            kt = kE[..., t, :, :] * f[..., None, :]
            A[..., b:b + SUB, t * SUB:(t + 1) * SUB] = mm3(
                q[..., s, :, :], kt.transpose(-1, -2))
            f = f * G[..., t, :]
    P0 = torch.ones_like(G)                           # prod_{u' < s} G_u'
    for s in range(1, ns):
        P0[..., s, :] = P0[..., s - 1, :] * G[..., s - 1, :]
    rt = (q * P0[..., None, :]).reshape(B, H, nc, L, K)
    y = mm3(rt, Sc) + mm3(A, vc)                      # (B, H, nc, L, V)
    y = y.permute(0, 2, 3, 1, 4).reshape(B, nc * L, H, V)[:, :S]
    return y, st


# -- B5: the SSD in chunks of Q, decays referenced at sub-chunks of 16 --------

def _shfl_scan(x, dim):
    """Inclusive prefix sum along ``dim`` (length 16) in the order of a
    Hillis-Steele shuffle scan: offsets 1, 2, 4, 8."""
    n = x.shape[dim]
    idx = torch.arange(n)
    off = 1
    while off < n:
        shifted = torch.roll(x, off, dim)
        mask = (idx >= off).view(*([1] * (x.dim() + dim)), n,
                                 *([1] * (-dim - 1)))
        x = x + torch.where(mask, shifted, torch.zeros_like(shifted))
        off *= 2
    return x


def ssd_mirror(xdt, la, Bm, Cm, state0=None):
    """The SSD kernel's tensor-core route (two launches) in float32.

    The cumulative log-decay of a chunk is kept as per-sub-chunk pieces:
    l (inclusive local prefix sum), s (exclusive local suffix sum) and T
    (the sub-chunk's sum), each from a shuffle scan of at most 16 terms, so
    every exponent is either a difference of two sums of at most 16 terms
    (a pair inside one sub-chunk) or a sum of non-positive pieces (no
    cancellation).  G = C.B^T is exact (bf16 products in float32); M = G o
    exp(cs_i - cs_j) for j <= i only.  Chunks are grouped in segments of
    TC_SEG: launch 1 forms each segment's state contribution, launch 2
    each segment's entry state from the earlier ones, then walks the
    segment's chunks with the state."""
    Q, SUBQ = SSD.TC_CHUNK, SSD.TC_SUB
    B, S, H, P = xdt.shape
    N = Bm.shape[-1]
    nc = -(-S // Q)
    pad = nc * Q - S

    def chunks(t):               # (B, S, ...) -> (B, nc, Q, ...), zero-padded
        t = t.to(F32)
        if pad:
            t = torch.cat([t, torch.zeros(B, pad, *t.shape[2:])], 1)
        return t.view(B, nc, Q, *t.shape[2:])

    xc, lc, bc, cc = chunks(xdt), chunks(la), chunks(Bm), chunks(Cm)
    ns = Q // SUBQ
    lq = lc.view(B, nc, ns, SUBQ, H)
    l = _shfl_scan(lq, -2)                         # inclusive prefix
    s = _shfl_scan(lq.flip(-2), -2).flip(-2)       # inclusive suffix ...
    s = torch.cat([s[..., 1:, :], torch.zeros_like(s[..., :1, :])], -2)
    # ... shifted by one step: the exclusive suffix
    T = l[..., -1, :]                                        # (B, nc, ns, H)
    i_blk = torch.arange(Q) // SUBQ

    def blocks_sum(lo, hi):      # sum of T over sub-chunks lo..hi-1
        out = torch.zeros(B, nc, H)
        for u in range(lo, hi):
            out = out + T[:, :, u]
        return out

    lf, sf = l.reshape(B, nc, Q, H), s.reshape(B, nc, Q, H)
    # exp(cs_i): l_i plus the earlier sub-chunks' sums (all <= 0)
    before = torch.stack([blocks_sum(0, int(b)) for b in i_blk], 2)
    ecs = torch.exp(lf + before)                             # (B, nc, Q, H)
    # exp(cs_last - cs_j): s_j plus the later sub-chunks' sums
    after = torch.stack([blocks_sum(int(b) + 1, ns) for b in i_blk], 2)
    wj = torch.exp(sf + after)
    dec = torch.exp(blocks_sum(0, ns))                       # (B, nc, H)
    # the decay exponent of each visible pair (j <= i)
    expo = torch.zeros(B, nc, Q, Q, H)
    for i in range(Q):
        bi = int(i_blk[i])
        for j in range(i + 1):
            bj = int(i_blk[j])
            if bi == bj:
                expo[:, :, i, j] = lf[:, :, i] - lf[:, :, j]
            else:
                expo[:, :, i, j] = (lf[:, :, i] + sf[:, :, j]
                                    + blocks_sum(bj + 1, bi))
    visible = torch.tril(torch.ones(Q, Q, dtype=torch.bool))[..., None]

    # launch 1: each segment's state contribution, from zero, and decay;
    # the state's step takes B^T (w o xdt), B exact: two products
    G = cc @ bc.transpose(-1, -2)                            # (B, nc, Q, Q)
    M = torch.where(visible, G[..., None] * torch.exp(expo), 0.0)
    bT = bc.transpose(-1, -2)[:, :, None]                    # (B,nc,1,N,Q)
    xh = xc.permute(0, 1, 3, 2, 4)                           # (B,nc,H,Q,P)
    wx = wj.permute(0, 1, 3, 2)[..., None] * xh              # (B,nc,H,Q,P)
    nseg = -(-nc // SSD.TC_SEG)
    seg_dS, seg_dec = [], []
    for sg in range(nseg):
        acc, dseg = torch.zeros(B, H, N, P), torch.ones(B, H)
        for c in range(sg * SSD.TC_SEG, min(nc, (sg + 1) * SSD.TC_SEG)):
            acc = dec[:, c, :, None, None] * acc + mm2(bT[:, c], wx[:, c])
            dseg = dseg * dec[:, c]
        seg_dS.append(acc)
        seg_dec.append(dseg)
    # launch 2: each segment's entry state from the initial state and the
    # earlier segments, then its chunks in order: y, then the state's step
    s0 = torch.zeros(B, H, N, P) if state0 is None else state0.to(F32)
    y = torch.empty(B, nc, H, Q, P)
    for sg in range(nseg):
        st = s0
        for s2 in range(sg):
            st = seg_dec[s2][..., None, None] * st + seg_dS[s2]
        for c in range(sg * SSD.TC_SEG, min(nc, (sg + 1) * SSD.TC_SEG)):
            y[:, c] = mm3(M[:, c].permute(0, 3, 1, 2), xh[:, c]) \
                + ecs[:, c].transpose(1, 2)[..., None] * mm2(cc[:, c, None], st)
            st = dec[:, c, :, None, None] * st + mm2(bT[:, c], wx[:, c])
    y = y.permute(0, 1, 3, 2, 4).reshape(B, nc * Q, H, P)[:, :S]
    return y, st


# -- inputs -------------------------------------------------------------------

def _rwkv_inputs(rng, B, S, H, K, V, *, zeros=0, denormals=0, state=True):
    """rwkv6-3b's full-width statistics (r, k, v ~ N(0, 1) rounded to bf16,
    w = exp(-exp(N(0, 1))), down to about e^-20 and below), optionally with
    exact zeros and denormals planted in w, and a nonzero state."""
    f = np.float32
    r, k, v = (torch.from_numpy(rng.normal(size=(B, S, H, C)).astype(f))
               .bfloat16().float() for C in (K, K, V))
    w = np.exp(-np.exp(rng.normal(size=(B, S, H, K)))).astype(f)
    flat = w.reshape(-1)
    at = rng.choice(flat.size, zeros + denormals, replace=False)
    flat[at[:zeros]] = 0.0
    flat[at[zeros:]] = rng.uniform(1e-45, 1e-39, size=denormals).astype(f)
    u = torch.from_numpy(rng.normal(size=(H, K)).astype(f))
    s0 = torch.from_numpy(rng.normal(size=(B, H, K, V)).astype(f)) \
        if state else None
    return r, k, v, torch.from_numpy(w), u, s0


def _ssd_inputs(rng, B, S, H, P, N, *, state=True, decay=1.0):
    """zamba2's init statistics, as the card tests draw them: dt =
    softplus(N(0, 1)), la = -decay dt, xdt = N(0, 1) dt, B and C bf16.
    A small ``decay`` keeps the state alive across the route's segments of
    256 steps (at decay 1 a segment decays it by about e^-200)."""
    f = np.float32
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H))))
    xdt = torch.from_numpy((rng.normal(size=(B, S, H, P)) * dt[..., None])
                           .astype(f))
    la = torch.from_numpy((-decay * dt).astype(f))
    bm, cm = (torch.from_numpy(rng.normal(size=(B, S, N)).astype(f))
              .bfloat16().float() for _ in range(2))
    s0 = torch.from_numpy(rng.normal(size=(B, H, N, P)).astype(f)) \
        if state else None
    return xdt, la, bm, cm, s0


def _rel(got, want):
    """max |d| over max(1, max |want|), as the card's gates measure it."""
    return ((got - want).abs().max()
            / max(1.0, want.abs().max().item())).item()


# -- the TF32 emulation itself --------------------------------------------------

def test_tf32_rounding_and_split():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
                      1 + 2 ** -12, 3.0e-39, 0.0], dtype=F32)
    got = tf32(x)
    want = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 * 2 ** -10,
                         -(1 + 2 ** -10), 1.0], dtype=F32)
    assert torch.equal(got[:5], want)            # ties away from zero
    assert torch.equal(tf32(got), got)
    assert got[6] == 0
    a = torch.from_numpy(np.random.default_rng(0).normal(size=4096)
                         .astype(np.float32))
    hi, lo = split(a)
    assert ((hi + lo - a).abs() <= a.abs() * 2.0 ** -21).all()
    assert (((hi.view(torch.int32) | lo.view(torch.int32)) & 0x1FFF) == 0).all()


# -- B4 --------------------------------------------------------------------------

# (B, S, H, zeros, denormals, with state): full-width statistics at reduced
# H (S 1024 is the prefill's bucket), zeros and denormals planted in w, one
# step short of a chunk, on its edge and one past it, a ragged length, from
# zeros
RWKV_MIRROR_CASES = [
    (1, 1024, 2, 0, 0, True),
    (1, 256, 2, 40, 40, True),
    (2, 63, 1, 0, 0, True),
    (2, 64, 1, 0, 0, True),
    (2, 65, 1, 3, 3, True),
    (1, 200, 2, 0, 0, True),
    (1, 200, 2, 0, 0, False),
]


@pytest.mark.parametrize("B,S,H,zeros,denormals,state", RWKV_MIRROR_CASES)
def test_rwkv6_mirror_matches_plain(B, S, H, zeros, denormals, state):
    rng = np.random.default_rng(4 + S + zeros)
    r, k, v, w, u, s0 = _rwkv_inputs(rng, B, S, H, 64, 64, zeros=zeros,
                                     denormals=denormals, state=state)
    if zeros:
        assert (w == 0).sum() == zeros
    want_y, want_s = rwkv6_scan_plain(r, k, v, w, u, s0)
    y, st = rwkv6_mirror(r, k, v, w, u, s0)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    assert _rel(y, want_y) <= RWKV_REL
    assert _rel(st, want_s) <= RWKV_REL


def test_rwkv6_mirror_matches_the_reference_oracle():
    rng = np.random.default_rng(11)
    r, k, v, w, u, s0 = _rwkv_inputs(rng, 1, 130, 2, 64, 64, zeros=2,
                                     denormals=2)
    y, st = rwkv6_mirror(r, k, v, w, u, s0)
    jy, js = jref.rwkv6_scan(*(t.numpy() for t in (r, k, v, w, u, s0)))
    assert _rel(y, torch.from_numpy(np.asarray(jy))) <= RWKV_REL
    assert _rel(st, torch.from_numpy(np.asarray(js))) <= RWKV_REL


def test_rwkv6_one_rounding_to_tf32_misses_the_limit():
    """Why the route splits: the same decomposition with each product
    operand rounded once to TF32 (one product) misses RWKV_REL."""
    global mm3
    rng = np.random.default_rng(4)
    r, k, v, w, u, s0 = _rwkv_inputs(rng, 1, 256, 2, 64, 64)
    want_y, _ = rwkv6_scan_plain(r, k, v, w, u, s0)
    keep = mm3
    mm3 = lambda a, b: tf32(a) @ tf32(b)  # noqa: E731
    try:
        y, _ = rwkv6_mirror(r, k, v, w, u, s0)
    finally:
        mm3 = keep
    assert _rel(y, want_y) > RWKV_REL


# -- B5 --------------------------------------------------------------------------

# (B, S, H, with state, decay): full-width statistics at reduced H (S 1000
# as zamba2's prefill, its last chunk ragged), one step short of a chunk,
# on its edge and one past it, from zeros, and a slow decay that carries
# the state across four segments
SSD_MIRROR_CASES = [
    (2, 1000, 3, True, 1.0),
    (1, 63, 2, True, 1.0),
    (1, 64, 2, True, 1.0),
    (1, 65, 2, True, 1.0),
    (2, 200, 2, False, 1.0),
    (1, 1000, 2, True, 0.005),
]


@pytest.mark.parametrize("B,S,H,state,decay", SSD_MIRROR_CASES)
def test_ssd_mirror_matches_plain(B, S, H, state, decay):
    rng = np.random.default_rng(7 + S)
    xdt, la, bm, cm, s0 = _ssd_inputs(rng, B, S, H, 64, 64, state=state,
                                      decay=decay)
    want_y, want_s = ssd_scan_plain(xdt, la, bm, cm, s0)
    y, st = ssd_mirror(xdt, la, bm, cm, s0)
    assert _rel(y, want_y) <= SSD_REL
    assert _rel(st, want_s) <= SSD_REL


def test_ssd_mirror_matches_the_reference_oracle():
    rng = np.random.default_rng(12)
    xdt, la, bm, cm, s0 = _ssd_inputs(rng, 1, 130, 2, 64, 64)
    y, st = ssd_mirror(xdt, la, bm, cm, s0)
    jy, js = jref.ssd_scan(*(t.numpy() for t in (xdt, la, bm, cm, s0)))
    assert _rel(y, torch.from_numpy(np.asarray(jy))) <= SSD_REL
    assert _rel(st, torch.from_numpy(np.asarray(js))) <= SSD_REL


# -- the routes, from shapes only ---------------------------------------------

@pytest.mark.parametrize("S,K,V,want", [
    (1024, 64, 64, True), (64, 64, 64, True), (65, 64, 64, True),
    (63, 64, 64, False), (1, 64, 64, False), (1024, 32, 32, False),
    (1024, 64, 32, False), (1024, 16, 64, False)])
def test_rwkv6_tensor_core_route_reads_shapes(S, K, V, want):
    r = torch.empty(1, S, 2, K, device="meta")
    v = torch.empty(1, S, 2, V, device="meta")
    assert RW.tensor_core_route(r, v) is want


@pytest.mark.parametrize("S,P,N,bc,want", [
    (1000, 64, 64, torch.bfloat16, True), (64, 64, 64, torch.bfloat16, True),
    (63, 64, 64, torch.bfloat16, False), (1, 64, 64, torch.bfloat16, False),
    (1000, 64, 64, torch.float32, False), (1000, 32, 64, torch.bfloat16, False),
    (1000, 64, 16, torch.bfloat16, False)])
def test_ssd_tensor_core_route_reads_shapes_and_dtype(S, P, N, bc, want):
    xdt = torch.empty(1, S, 2, P, device="meta")
    bm = torch.empty(1, S, N, dtype=bc, device="meta")
    assert SSD.tensor_core_route(xdt, bm) is want


def test_workspaces_follow_shapes():
    """rwkv6-3b's prefill: 16 chunk states and decays a head (10.6 MB);
    zamba2-7b's: 4 segments of 4 chunks, the initial state and each
    segment's contribution (7.3 MB)."""
    assert RW.workspace_elems(1, 1024, 40) == 40 * 16 * (64 * 64 + 64)
    assert RW.workspace_elems(1, 1025, 40) == 40 * 17 * (64 * 64 + 64)
    assert SSD.segments(1000) == 4 and SSD.segments(64) == 1 \
        and SSD.segments(257) == 2
    assert SSD.workspace_elems(4, 1000, 112) == 4 * 112 * (5 * 64 * 64 + 4)


def test_cpu_scans_count_plain_and_no_tensor_core_call():
    from repro_torch.kernels import ops
    rng = np.random.default_rng(3)
    r, k, v, w, u, s0 = _rwkv_inputs(rng, 1, 70, 2, 64, 64)
    xdt, la, bm, cm, s1 = _ssd_inputs(rng, 1, 70, 2, 64, 64)
    ops.reset_counts()
    ops.rwkv6_scan(r, k, v, w, u, s0)
    ops.ssd_scan(xdt, la, bm.bfloat16(), cm.bfloat16(), s1)
    assert ops.COUNTS["rwkv6_scan"].plain == ops.COUNTS["ssd_scan"].plain == 1
    assert all(c.kernel == 0 for c in ops.COUNTS.values())
    assert ops.COUNTS["rwkv6_scan_tc"].plain == ops.COUNTS["ssd_scan_tc"].plain \
        == 0
    ops.reset_counts()
