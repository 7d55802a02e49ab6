"""CPU mirrors of the chunk-parallel tensor-core routes of the two scans'
backward kernels, B4's (``csrc/rwkv6_scan.cu``, the RWKV-6 wkv) and B5's
(``csrc/ssd_scan.cu``, the Mamba-2 SSD), held against autograd through the
plain versions (``rwkv6_scan_plain`` / ``ssd_scan_plain``).

Each mirror does its kernel's arithmetic step by step in float32, launch by
launch: each chunk's own state and gradient contributions, the sequential
passes that turn them into every chunk's entry state S_c and the gradient
G_c that reaches its last state from later steps, then the chunks in
parallel.  Every tensor-core product is emulated with its TF32 split (the
helpers of ``tests/test_torch_scans.py``): three products where both
operands are float32, two where one is exact in TF32 (bf16 values).  The
CUDA kernels cannot run here; the mirrors show that the decomposition is
right and meets the card's float32 limit before a card sees it, in the
cases that are hard for it: the full-width decay range, exact zeros and
denormals in w, a length one step short of a chunk, on a chunk edge and
one past it, a ragged length, a nonzero initial state and final-state
gradient, and (B5) more than one group of heads summing into dB and dC.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import rwkv6_scan as RW
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from test_torch_scans import (_rel, _rwkv_inputs, _shfl_scan, _ssd_inputs,
                              mm3, split, tf32)

# the card's limits (SCAN_BWD_TOL of tests/test_torch_gpu.py): max |d| over
# max(1, max |autograd|); the mirrors run in float32 and are held to its
SCAN_BWD_TOL = {"float32": 1e-5, "bfloat16": 4e-3}
F32 = torch.float32


def mmx(a, b, exact_a=False, exact_b=False):
    """``a @ b`` as the kernels' split TF32 products: an operand exact in
    TF32 (bf16 values) is used as it is and the other split (two
    products); else 3xTF32."""
    if exact_a:
        assert torch.equal(tf32(a), a)
        bh, bl = split(b)
        return a @ bl + a @ bh
    if exact_b:
        assert torch.equal(tf32(b), b)
        ah, al = split(a)
        return al @ b + ah @ b
    return mm3(a, b)


def _grads(fn, ins, cots):
    leaves = [None if t is None else t.detach().clone().requires_grad_(True)
              for t in ins]
    outs = fn(*leaves)
    torch.autograd.backward(list(outs), list(cots))
    return [None if t is None else t.grad for t in leaves]


# -- B4 ---------------------------------------------------------------------

def rwkv6_bwd_mirror(r, k, v, w, u, state0, dy, dsT, exact):
    """The wkv backward's tensor-core route: ``(dr, dk, dv, dw, du,
    dstate0)``; ``exact`` when r, k, v are bf16 (v exact in TF32).

    Launch 1 (the forward's) gives each chunk's state contribution dS_c
    and decay; launch 2 each chunk's gradient contribution dG_c = sum_i
    (r_i o prod_{c0<=s<i} w_s) dy_i^T; the passes S_{c+1} = dec_c S_c +
    dS_c and G_{c-1} = dec_c G_c + dG_c.  Then per chunk, with the
    sub-chunk factors Pf_t = prod_{b<=s<t} w_s, Ef_t = prod_{t<s<=e} w_s
    (b, e: the sub-chunk's first and last step) and the sub-chunks'
    products Gs_u, and DV_tj = dy_t . v_j:
        dr_t = Pf_t o (prod_{u<s} Gs_u o (S_c dy_t)
                       + sum_{j in u<s} DV_tj (k_j Ef_j prod_{u<u'<s} Gs))
               + [pairs j < t of t's sub-chunk] + u o k_t DV_tt
        dk_j = Ef_j o (prod_{u'>u} Gs o (G_c v_j)
                       + sum_{t in s>u} DV_tj (r_t Pf_t prod_{u<u'<s} Gs))
               + [pairs t > j of j's sub-chunk] + u o r_j DV_jj
        dv = A^T dy + (k o prod_{t<s<=last} w) G_c, A the forward's
    the pairs inside a sub-chunk on CUDA cores, walking with a running
    product.  dw_t = rowsum(G_t o S_{t-1}) with S_{t-1} and G_t written out
    in the same chunk form, Lam_xy = prod_{y<s<x} w_s, for t in sub-chunk
    u:
        dw_t = Ef_t Pf_t Om_u + Ef_t Fw_t + Pf_t Bw_t + T4_t
        Om_u = NG PG <G_c, S_c> + NG K_u + PG M_u + C_u
    (PG, NG: the products of the sub-chunks before and after u) with K_u =
    sum_{j before u} Lam_{b_u j} k_j (G_c v_j), M_u = sum_{i after u}
    Lam_{i e_u} r_i (S_c dy_i), C_u the pairs i after u, j before u; Fw_t
    = sum_{j<t in u} Lam_tj k_j Dk_j and Bw_t = sum_{i>t in u} Lam_it r_i
    Dr_i over dk's and dr's brackets (the two in parentheses above); T4_t
    the pairs j < t < i both in u.  Every factor a product of w over a
    range of steps; du the chunks' partials sum_t r_t k_t DV_tt, summed in
    (batch, chunk) order."""
    L, SUB = RW.TC_CHUNK, RW.TC_SUB
    B, S, H, K = r.shape
    V = v.shape[-1]
    nc = -(-S // L)
    pad = nc * L - S
    ns = L // SUB

    def chunks(t, fill):        # (B, S, H, C) -> (B, H, nc, L, C), padded
        t = t.to(F32)
        if pad:
            t = torch.cat([t, torch.full((B, pad, H, t.shape[-1]), fill)], 1)
        return t.view(B, nc, L, H, -1).permute(0, 3, 1, 2, 4)

    rc, kc, vc, wc, gc = (chunks(r, 0.0), chunks(k, 0.0), chunks(v, 0.0),
                          chunks(w, 1.0), chunks(dy, 0.0))
    sub = lambda t: t.reshape(B, H, nc, ns, SUB, -1)  # noqa: E731
    rs, ks, ws = sub(rc), sub(kc), sub(wc)
    # sub-chunk factors, each a product of w (never a log or a quotient)
    Pf, Ef = torch.empty_like(ws), torch.empty_like(ws)
    p = torch.ones_like(ws[..., 0, :])
    for t in range(SUB):
        Pf[..., t, :] = p
        p = p * ws[..., t, :]
    Gp = p                                   # launch 2's sub-chunk products
    e = torch.ones_like(p)
    for t in reversed(range(SUB)):
        Ef[..., t, :] = e
        e = e * ws[..., t, :]
    Gs = e                                   # (B, H, nc, ns, K)
    after = torch.ones_like(Gs)              # prod_{u' > u} Gs_u'
    for s in reversed(range(ns - 1)):
        after[..., s, :] = after[..., s + 1, :] * Gs[..., s + 1, :]
    before = torch.ones_like(Gp)             # prod_{u' < u} Gp_u'
    for s in range(1, ns):
        before[..., s, :] = before[..., s - 1, :] * Gp[..., s - 1, :]

    # launches 1-2: each chunk's contributions and decay
    khat = (ks * Ef * after[..., None, :]).reshape(B, H, nc, L, K)
    dS = mmx(khat.transpose(-1, -2), vc, exact_b=exact)
    dec = Gs[..., 0, :] * after[..., 0, :]   # (B, H, nc, K)
    rhat = (rs * Pf * before[..., None, :]).reshape(B, H, nc, L, K)
    dG = mm3(rhat.transpose(-1, -2), gc)

    # the passes: every chunk's entry state, the gradient at its end
    st = torch.zeros(B, H, K, V) if state0 is None else state0.to(F32).clone()
    Sc = []
    for c in range(nc):
        Sc.append(st)
        st = dec[:, :, c, :, None] * st + dS[:, :, c]
    g = torch.zeros(B, H, K, V) if dsT is None else dsT.to(F32).clone()
    Gc = [None] * nc
    for c in reversed(range(nc)):
        Gc[c] = g
        g = dec[:, :, c, :, None] * g + dG[:, :, c]
    ds0 = g
    Sc, Gc = torch.stack(Sc, 2), torch.stack(Gc, 2)    # (B, H, nc, K, V)

    # the chunks in parallel
    DV = mmx(gc, vc.transpose(-1, -2), exact_b=exact)   # (.., L, L)
    dvv = DV.reshape(B, H, nc, ns, SUB, ns, SUB)
    # A: the forward's intra-chunk matrix (bonus on the diagonal)
    q = rs * Pf
    kE = ks * Ef
    uu = u.to(F32)[None, :, None, None, :]
    A = torch.zeros(B, H, nc, L, L)
    rows = torch.arange(SUB)[:, None]
    for s in range(ns):
        b = s * SUB
        acc = torch.zeros(B, H, nc, SUB, SUB)
        pw = torch.zeros_like(rs[..., s, :, :])
        for jj in reversed(range(SUB)):
            pw = torch.where(rows == jj + 1, torch.ones_like(pw), pw)
            acc[..., jj] = (rs[..., s, :, :] * ks[..., s, jj, None, :]
                            * pw).sum(-1)
            pw = pw * ws[..., s, jj, None, :]
        bonus = (rs[..., s, :, :] * uu * ks[..., s, :, :]).sum(-1)
        A[..., b:b + SUB, b:b + SUB] = torch.tril(acc, -1) \
            + torch.diag_embed(bonus)
        f = torch.ones_like(Gs[..., 0, :])
        for t in reversed(range(s)):
            kt = kE[..., t, :, :] * f[..., None, :]
            A[..., b:b + SUB, t * SUB:(t + 1) * SUB] = mm3(
                q[..., s, :, :], kt.transpose(-1, -2))
            f = f * Gs[..., t, :]

    SdT = mm3(gc, Sc.transpose(-1, -2)).reshape(B, H, nc, ns, SUB, K)
    GvT = mmx(vc, Gc.transpose(-1, -2), exact_a=exact) \
        .reshape(B, H, nc, ns, SUB, K)
    gamma = (Gc * Sc).sum(-1)                        # (B, H, nc, K)
    mM = (Pf * rs * SdT).sum(-2)                     # (B, H, nc, ns, K)
    pK = (Ef * ks * GvT).sum(-2)
    one = torch.ones_like(Gs[..., 0, :])

    def prod(lo, hi):            # prod_{lo <= u' < hi} Gs_u'
        f = one
        for x in range(lo, hi):
            f = f * Gs[..., x, :]
        return f

    dr = torch.empty(B, H, nc, ns, SUB, K)
    dk = torch.empty(B, H, nc, ns, SUB, K)
    dw = torch.empty(B, H, nc, ns, SUB, K)
    for s in range(ns):
        PG, NG = prod(0, s), prod(s + 1, ns)
        # dr: the cross sub-chunks u < s and the entry state
        X = torch.zeros(B, H, nc, SUB, K)
        F = one                                      # prod_{u<u'<s} Gs
        for uo in reversed(range(s)):
            X = X + mm3(dvv[..., s, :, uo, :],
                        kE[..., uo, :, :] * F[..., None, :])
            F = F * Gs[..., uo, :]
        Dr = PG[..., None, :] * SdT[..., s, :, :] + X
        # the pairs j < t inside the sub-chunk: walk j down from t - 1
        intra = torch.zeros(B, H, nc, SUB, K)
        for t in range(SUB):
            pr = torch.ones(B, H, nc, K)
            for j in reversed(range(t)):
                intra[..., t, :] = intra[..., t, :] + dvv[..., s, t, s, j,
                                                          None] \
                    * ks[..., s, j, :] * pr
                pr = pr * ws[..., s, j, :]
        diag = torch.diagonal(dvv[..., s, :, s, :], dim1=-2, dim2=-1)
        dr[..., s, :, :] = Pf[..., s, :, :] * Dr + intra \
            + uu * ks[..., s, :, :] * diag[..., None]
        # dk: the cross sub-chunks s' > s and the exit gradient
        Y = torch.zeros(B, H, nc, SUB, K)
        F = one                                      # prod_{s<u'<s'} Gs
        for so in range(s + 1, ns):
            Y = Y + mm3(dvv[..., so, :, s, :].transpose(-1, -2),
                        q[..., so, :, :] * F[..., None, :])
            F = F * Gs[..., so, :]
        Dk = NG[..., None, :] * GvT[..., s, :, :] + Y
        intra = torch.zeros(B, H, nc, SUB, K)
        for j in range(SUB):
            pr = torch.ones(B, H, nc, K)
            for t in range(j + 1, SUB):
                intra[..., j, :] = intra[..., j, :] + dvv[..., s, t, s, j,
                                                          None] \
                    * rs[..., s, t, :] * pr
                pr = pr * ws[..., s, t, :]
        dk[..., s, :, :] = Ef[..., s, :, :] * Dk + intra \
            + uu * rs[..., s, :, :] * diag[..., None]
        # dw: the carries from the other sub-chunks, the pairs across it
        Kc, Mc = torch.zeros_like(one), torch.zeros_like(one)
        for uo in range(s):
            Kc = Gs[..., uo, :] * Kc + pK[..., uo, :]
        for uo in reversed(range(s + 1, ns)):
            Mc = Gs[..., uo, :] * Mc + mM[..., uo, :]
        C = torch.zeros_like(one)
        for si in range(s + 1, ns):
            for sj in range(s):
                W = dvv[..., si, :, sj, :] @ (
                    kE[..., sj, :, :] * prod(sj + 1, s)[..., None, :])
                C = C + (q[..., si, :, :] * prod(s + 1, si)[..., None, :]
                         * W).sum(-2)
        Om = NG * PG * gamma + NG * Kc + PG * Mc + C
        # the sub-chunk's own steps: Fw forward, Bw back, and the pairs
        # j < t < i inside it (Z[i] = sum_{j<t} Lam_tj k_j DV_ij)
        Fw, Bw = torch.zeros(B, H, nc, SUB, K), torch.zeros(B, H, nc, SUB, K)
        f = torch.zeros_like(one)
        for t in range(SUB):
            Fw[..., t, :] = f
            f = ws[..., s, t, :] * f + ks[..., s, t, :] * Dk[..., t, :]
        f = torch.zeros_like(one)
        for t in reversed(range(SUB)):
            Bw[..., t, :] = f
            f = ws[..., s, t, :] * f + rs[..., s, t, :] * Dr[..., t, :]
        T4 = torch.zeros(B, H, nc, SUB, K)
        Z = torch.zeros(B, H, nc, SUB, K)
        for t in range(SUB):
            pp = torch.ones_like(one)
            for i in range(t + 1, SUB):
                T4[..., t, :] = T4[..., t, :] + pp * rs[..., s, i, :] \
                    * Z[..., i, :]
                pp = pp * ws[..., s, i, :]
            Z = ws[..., s, t, None, :] * Z + ks[..., s, t, None, :] \
                * dvv[..., s, :, s, t, None]
        dw[..., s, :, :] = Ef[..., s, :, :] * Pf[..., s, :, :] \
            * Om[..., None, :] + Ef[..., s, :, :] * Fw \
            + Pf[..., s, :, :] * Bw + T4
    dv = mm3(A.transpose(-1, -2), gc) + mm3(khat, Gc)
    # du: a partial a (batch, chunk) from DV's diagonal, summed in that
    # order
    part = (rc * kc * torch.diagonal(DV, dim1=-2, dim2=-1)[..., None]) \
        .sum(-2)                                     # (B, H, nc, K)
    du = torch.zeros(H, K)
    for b in range(B):
        for c in range(nc):
            du = du + part[b, :, c]

    def unchunk(t):              # (B, H, nc, L, C) -> (B, S, H, C)
        return t.reshape(B, H, nc * L, -1).permute(0, 2, 1, 3)[:, :S]

    return (unchunk(dr.reshape(B, H, nc, L, K)),
            unchunk(dk.reshape(B, H, nc, L, K)), unchunk(dv),
            unchunk(dw.reshape(B, H, nc, L, K)), du,
            None if state0 is None else ds0)


# (B, S, H, zeros, denormals, with state and dsT, bf16 r/k/v): zeros and
# denormals planted in w, a chunk edge and one step past it, one short of
# the second chunk, a ragged length, float32 r/k/v, from zeros
RWKV_BWD_CASES = [
    (1, 256, 2, 40, 40, True, True),
    (2, 64, 1, 0, 0, True, True),
    (1, 65, 2, 3, 3, True, True),
    (1, 127, 1, 0, 0, True, True),
    (1, 200, 2, 0, 0, True, False),
    (1, 130, 1, 2, 2, False, True),
]


@pytest.mark.parametrize("B,S,H,zeros,denormals,state,bf16",
                         RWKV_BWD_CASES)
def test_rwkv6_bwd_mirror_matches_autograd(B, S, H, zeros, denormals, state,
                                           bf16):
    rng = np.random.default_rng(40 + S + zeros)
    r, k, v, w, u, s0 = _rwkv_inputs(rng, B, S, H, 64, 64, zeros=zeros,
                                     denormals=denormals, state=state)
    if not bf16:     # float32 values: v no longer exact in TF32
        r, k, v = (t + torch.from_numpy(rng.normal(size=t.shape).astype(
            np.float32)) * 1e-3 for t in (r, k, v))
    if zeros:
        assert (w == 0).sum() == zeros
    dy = torch.from_numpy(rng.normal(size=(B, S, H, 64)).astype(np.float32))
    dsT = torch.from_numpy(rng.normal(size=(B, H, 64, 64)).astype(
        np.float32)) if state else None
    want = _grads(lambda *a: rwkv6_scan_plain(*a), (r, k, v, w, u, s0),
                  (dy, torch.zeros(B, H, 64, 64) if dsT is None else dsT))
    got = rwkv6_bwd_mirror(r, k, v, w, u, s0, dy, dsT, exact=bf16)
    for name, g, wv in zip(("dr", "dk", "dv", "dw", "du", "dstate0"), got,
                           want):
        if wv is None:
            assert g is None
            continue
        assert torch.isfinite(g).all(), name
        assert _rel(g, wv) <= SCAN_BWD_TOL["float32"], (name, _rel(g, wv))


# -- B5 ---------------------------------------------------------------------

def ssd_bwd_mirror(xdt, la, Bm, Cm, state0, dy, dsT, group):
    """The SSD backward's tensor-core route: ``(dxdt, dla, dB, dC,
    dstate0)`` in float32, B and C bf16 values (exact in TF32).

    Launch 1: each chunk's state contribution dS_c = B^T (w o xdt) and
    gradient contribution dG_c = C^T (e o dy), with e_i = exp(cs_i), w_j =
    exp(cs_last - cs_j), cs the chunk's inclusive cumsum of la kept as
    sub-chunk pieces (the forward's); the passes give S_c and G_c.  Then
    per chunk and group of ``group`` heads: CB = C B^T once (exact), and
    per head, with L_kj = exp(cs_k - cs_j) for j <= k (0 above), DX = dy
    xdt^T, D = DX o L, M = CB o L:
        dxdt = M^T dy + w o (B G_c)
        dC_h = D B + e o (dy S_c^T),   dB_h = D^T C + w o (xdt G_c^T)
        dla_t = sum_{k>=t, j<t} CB_kj D_kj + sum_{k>=t} alpha_k
                + sum_{j<t} beta_j + exp(cs_last) <G_c, S_c>
    with alpha_k = C_k . (e o dy S_c^T)_k and beta_j = xdt_j . (w o B
    G_c)_j: every term a direct sum, no difference of two long sums.  dB
    and dC sum their heads in order inside the group, the groups in order
    after."""
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

    xc, lc, bc, cc, gc = (chunks(xdt), chunks(la), chunks(Bm), chunks(Cm),
                          chunks(dy))
    ns = Q // SUBQ
    lq = lc.view(B, nc, ns, SUBQ, H)
    l = _shfl_scan(lq, -2)
    s = _shfl_scan(lq.flip(-2), -2).flip(-2)
    s = torch.cat([s[..., 1:, :], torch.zeros_like(s[..., :1, :])], -2)
    T = l[..., -1, :]
    i_blk = torch.arange(Q) // SUBQ

    def blocks_sum(lo, hi):
        out = torch.zeros(B, nc, H)
        for uo in range(lo, hi):
            out = out + T[:, :, uo]
        return out

    lf, sf = l.reshape(B, nc, Q, H), s.reshape(B, nc, Q, H)
    ecs = torch.exp(lf + torch.stack([blocks_sum(0, int(b)) for b in i_blk],
                                     2))                    # (B, nc, Q, H)
    wj = torch.exp(sf + torch.stack([blocks_sum(int(b) + 1, ns)
                                     for b in i_blk], 2))
    dec = torch.exp(blocks_sum(0, ns))                      # (B, nc, H)
    expo = torch.zeros(B, nc, Q, Q, H)
    for i in range(Q):
        bi = int(i_blk[i])
        for j in range(i + 1):
            bj = int(i_blk[j])
            expo[:, :, i, j] = lf[:, :, i] - lf[:, :, j] if bi == bj else \
                lf[:, :, i] + sf[:, :, j] + blocks_sum(bj + 1, bi)
    visible = torch.tril(torch.ones(Q, Q, dtype=torch.bool))[..., None]
    Ldec = torch.where(visible, torch.exp(expo), 0.0) \
        .permute(0, 1, 4, 2, 3)                             # (B,nc,H,Q,Q)

    xh = xc.permute(0, 1, 3, 2, 4)                          # (B,nc,H,Q,P)
    gh = gc.permute(0, 1, 3, 2, 4)
    e_h = ecs.permute(0, 1, 3, 2)[..., None]                # (B,nc,H,Q,1)
    w_h = wj.permute(0, 1, 3, 2)[..., None]
    bT = bc.transpose(-1, -2)[:, :, None]                   # (B,nc,1,N,Q)
    cT = cc.transpose(-1, -2)[:, :, None]
    # launch 1 and the passes
    dS = mmx(bT, w_h * xh, exact_a=True)                    # (B,nc,H,N,P)
    dG = mmx(cT, e_h * gh, exact_a=True)
    st = torch.zeros(B, H, N, P) if state0 is None else state0.to(F32)
    Sc = []
    for c in range(nc):
        Sc.append(st)
        st = dec[:, c, :, None, None] * st + dS[:, c]
    g = torch.zeros(B, H, N, P) if dsT is None else dsT.to(F32)
    Gc = [None] * nc
    for c in reversed(range(nc)):
        Gc[c] = g
        g = dec[:, c, :, None, None] * g + dG[:, c]
    ds0 = g
    Sc, Gc = torch.stack(Sc, 1), torch.stack(Gc, 1)         # (B,nc,H,N,P)

    # the chunks in parallel
    CB = (cc @ bc.transpose(-1, -2))[:, :, None]            # (B,nc,1,Q,Q)
    DX = mm3(gh, xh.transpose(-1, -2))                      # (B,nc,H,Q,Q)
    D = DX * Ldec
    M = CB * Ldec
    bq, cq = bc[:, :, None], cc[:, :, None]                 # (B,nc,1,Q,N)
    BG = mmx(bq, Gc, exact_a=True)                          # (B,nc,H,Q,P)
    dx = mm3(M.transpose(-1, -2), gh) + w_h * BG
    E = e_h * mm3(gh, Sc.transpose(-1, -2))                 # (B,nc,H,Q,N)
    X = w_h * mm3(xh, Gc.transpose(-1, -2))
    dC_h = mmx(D, bq, exact_b=True) + E
    dB_h = mmx(D.transpose(-1, -2), cq, exact_b=True) + X
    alpha = (cq * E).sum(-1)                                # (B,nc,H,Q)
    beta = (xh * w_h * BG).sum(-1)
    gamma = dec * (Gc * Sc).sum((-1, -2))                   # (B,nc,H)
    Tt = torch.tril(CB * D, -1)
    pre = torch.cumsum(Tt, -1) - Tt                         # sum_{j<t}
    rect = torch.flip(torch.cumsum(torch.flip(pre, [-2]), -2), [-2])
    rect = torch.diagonal(rect, dim1=-2, dim2=-1)           # (B,nc,H,Q)
    suf = torch.flip(torch.cumsum(torch.flip(alpha, [-1]), -1), [-1])
    pre_b = torch.cumsum(beta, -1) - beta
    dla = rect + suf + pre_b + gamma[..., None]
    dB = torch.zeros(B, nc, Q, N)
    dC = torch.zeros(B, nc, Q, N)
    for h0 in range(0, H, group):
        pb, pc = torch.zeros(B, nc, Q, N), torch.zeros(B, nc, Q, N)
        for h in range(h0, min(H, h0 + group)):
            pb = pb + dB_h[:, :, h]
            pc = pc + dC_h[:, :, h]
        dB, dC = dB + pb, dC + pc

    dxdt = dx.permute(0, 1, 3, 2, 4).reshape(B, nc * Q, H, P)[:, :S]
    dla = dla.permute(0, 1, 3, 2).reshape(B, nc * Q, H)[:, :S]
    return (dxdt, dla, dB.reshape(B, nc * Q, N)[:, :S],
            dC.reshape(B, nc * Q, N)[:, :S],
            None if state0 is None else ds0)


# (B, S, H, with state and dsT, decay, heads a group): a chunk edge and one
# step past it, one short of the second chunk, a ragged length over more
# than one segment of the forward, three groups of heads summing into dB and
# dC (the last one short), from zeros, a slow decay that carries the state
# and the gradient across many chunks
SSD_BWD_CASES = [
    (1, 64, 2, True, 1.0, 8),
    (2, 65, 2, True, 1.0, 8),
    (1, 127, 3, True, 1.0, 8),
    (1, 300, 2, True, 0.005, 8),
    (1, 130, 5, True, 1.0, 2),
    (1, 200, 2, False, 1.0, 8),
]


@pytest.mark.parametrize("B,S,H,state,decay,group", SSD_BWD_CASES)
def test_ssd_bwd_mirror_matches_autograd(B, S, H, state, decay, group):
    rng = np.random.default_rng(50 + S + H)
    xdt, la, bm, cm, s0 = _ssd_inputs(rng, B, S, H, 64, 64, state=state,
                                      decay=decay)
    dy = torch.from_numpy(rng.normal(size=(B, S, H, 64)).astype(np.float32))
    dsT = torch.from_numpy(rng.normal(size=(B, H, 64, 64)).astype(
        np.float32)) if state else None
    want = _grads(lambda *a: ssd_scan_plain(*a), (xdt, la, bm, cm, s0),
                  (dy, torch.zeros(B, H, 64, 64) if dsT is None else dsT))
    got = ssd_bwd_mirror(xdt, la, bm, cm, s0, dy, dsT, group)
    for name, g, wv in zip(("dxdt", "dla", "dB", "dC", "dstate0"), got,
                           want):
        if wv is None:
            assert g is None
            continue
        assert torch.isfinite(g).all(), name
        assert _rel(g, wv) <= SCAN_BWD_TOL["float32"], (name, _rel(g, wv))


# -- the routes, from shapes and dtypes only ---------------------------------

@pytest.mark.parametrize("S,K,V,dtype,want", [
    (2048, 64, 64, torch.bfloat16, True), (64, 64, 64, torch.bfloat16, True),
    (65, 64, 64, torch.float32, True), (63, 64, 64, torch.bfloat16, False),
    (1, 64, 64, torch.float32, False), (2048, 32, 32, torch.bfloat16, False),
    (2048, 64, 32, torch.bfloat16, False), (70, 16, 16, torch.float32, False)])
def test_rwkv6_backward_route_reads_shapes(S, K, V, dtype, want):
    r = torch.empty(1, S, 2, K, dtype=dtype, device="meta")
    v = torch.empty(1, S, 2, V, dtype=dtype, device="meta")
    assert RW.backward_tensor_core_route(r, v) is want
    assert RW.backward_tensor_core_route(r, v) is RW.tensor_core_route(r, v)


@pytest.mark.parametrize("S,P,N,bc,want", [
    (2048, 64, 64, torch.bfloat16, True), (64, 64, 64, torch.bfloat16, True),
    (63, 64, 64, torch.bfloat16, False), (2048, 64, 64, torch.float32, False),
    (2048, 32, 64, torch.bfloat16, False), (70, 16, 8, torch.bfloat16, False)])
def test_ssd_backward_route_reads_shapes_and_dtype(S, P, N, bc, want):
    xdt = torch.empty(1, S, 2, P, device="meta")
    bm = torch.empty(1, S, N, dtype=bc, device="meta")
    assert SSD.backward_tensor_core_route(xdt, bm) is want


def test_backward_workspaces_follow_shapes():
    """Every chunk's entry state and end gradient, and its decays: 168 MB
    at rwkv6-3b's training call (B 4, S 2048, H 40), 470 MB at zamba2-7b's
    (H 112), whose dB/dC partials are one a group of 8 heads."""
    assert RW.bwd_workspace_elems(4, 2048, 40) == 4 * 40 * 32 * (
        2 * 64 * 64 + 64)
    assert RW.bwd_workspace_elems(1, 65, 2) == 2 * 2 * (2 * 64 * 64 + 64)
    assert SSD.bwd_workspace_elems(4, 2048, 112) == 4 * 112 * 32 * (
        2 * 64 * 64 + 1)
    assert SSD.BWD_TC_GROUP == 8 and -(-112 // SSD.BWD_TC_GROUP) == 14


def test_cpu_scan_backwards_count_no_kernel_and_no_tensor_core_call():
    """On the CPU autograd differentiates the plain versions: the scans
    count plain calls, and no backward count, ``_tc`` sub-count included,
    moves."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(5)
    r, k, v, w, u, s0 = (None if t is None else t.requires_grad_(True)
                         for t in _rwkv_inputs(rng, 1, 70, 2, 64, 64))
    xdt, la, bm, cm, s1 = _ssd_inputs(rng, 1, 70, 2, 64, 64)
    xdt.requires_grad_(True)
    ops.reset_counts()
    y, st = ops.rwkv6_scan(r, k, v, w, u, s0)
    (y.sum() + st.sum()).backward()
    y, st = ops.ssd_scan(xdt, la, bm.bfloat16(), cm.bfloat16(), s1)
    (y.sum() + st.sum()).backward()
    assert ops.COUNTS["rwkv6_scan"].plain == ops.COUNTS["ssd_scan"].plain == 1
    assert all(c.kernel == 0 for c in ops.COUNTS.values())
    for name in ("rwkv6_scan_bwd", "rwkv6_scan_bwd_tc", "ssd_scan_bwd",
                 "ssd_scan_bwd_tc"):
        assert ops.COUNTS[name].plain == 0, name
    assert r.grad is not None and xdt.grad is not None
    ops.reset_counts()
