"""The port's kernels against the reference package's: the plain PyTorch
versions (what a CPU tensor runs) against ``repro.kernels.ref`` and the
Pallas kernels in interpret mode, on the same numpy-seeded inputs; the
CPU route of the counted wrappers.  The CUDA kernels against their plain
versions on a card are in ``test_torch_gpu.py``, which imports no JAX, so
that it runs on a card's host without it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# f32: summation order only; bf16: one rounding of the output
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _pair(a: np.ndarray, dtype: str):
    """One numpy array as (jax array, torch tensor) of the same values."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 64), (3, 37, 128), (1, 256), (257, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_reference(shape, dtype):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.normal(size=shape).astype(np.float32), dtype)
    sj, st = _pair(rng.normal(size=shape[-1:]).astype(np.float32), "float32")
    got = _np(ref.rmsnorm(xt, st))
    tol = TOL[dtype]
    for want in (jref.rmsnorm(xj, sj), jops.rmsnorm(xj, sj)):
        np.testing.assert_allclose(got, _np(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# paged multi-query attention
# ---------------------------------------------------------------------------

def _paged_case(rng, B, W, Hq, Hkv, D, ps, N, P, dtype, dead_slot=False):
    """Inputs as numpy: ragged lengths whose deepest row stays in the table;
    tables avoid page N - 1 (the trash page); slot 0 full, optionally the
    last slot dead (length 0)."""
    q = rng.normal(size=(B, W, Hq, D)).astype(np.float32)
    kp = rng.normal(size=(N, ps, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(N, ps, Hkv, D)).astype(np.float32)
    tables = rng.integers(0, N - 1, size=(B, P)).astype(np.int32)
    lens = rng.integers(1, P * ps - W + 2, size=B).astype(np.int32)
    lens[0] = P * ps - W + 1
    if dead_slot:
        lens[-1] = 0
    return q, kp, vp, tables, lens


def _plain(q, kp, vp, tables, lens, dtype):
    q, kp, vp = (_pair(a, dtype)[1] for a in (q, kp, vp))
    return ref.paged_attention_mq(q, kp, vp, torch.from_numpy(tables),
                                  torch.from_numpy(lens))


def _run_both(q, kp, vp, tables, lens, dtype):
    """The port's plain version, and the reference's oracle and kernel."""
    qj, kj, vj = (_pair(a, dtype)[0] for a in (q, kp, vp))
    tj, lj = jnp.asarray(tables), jnp.asarray(lens)
    return _plain(q, kp, vp, tables, lens, dtype), (
        jref.paged_attention_mq(qj, kj, vj, tj, lj),
        jops.paged_attention_mq(qj, kj, vj, tj, lj))


@pytest.mark.parametrize("W", [1, 3, 8])
@pytest.mark.parametrize("G", [1, 2, 7])
def test_paged_attention_plain_matches_reference(W, G):
    rng = np.random.default_rng(10 * W + G)
    Hkv, D, ps, N, P, B = 2, 16, 8, 10, 3, 2
    case = _paged_case(rng, B, W, G * Hkv, Hkv, D, ps, N, P, "float32",
                       dead_slot=True)
    got, wants = _run_both(*case, "float32")
    for want in wants:
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)
    assert np.all(_np(got)[-1, 0] == 0.0)          # dead slot: zero row 0


def test_paged_attention_plain_bf16_matches_reference():
    rng = np.random.default_rng(3)
    case = _paged_case(rng, 2, 3, 4, 2, 16, 8, 8, 3, "bfloat16")
    got, wants = _run_both(*case, "bfloat16")
    for want in wants:
        np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)


def test_paged_attention_plain_trash_page_isolated():
    """What lands in the trash page (the last page id, which no live table
    row names) never perturbs a live row."""
    rng = np.random.default_rng(4)
    q, kp, vp, tables, lens = _paged_case(rng, 2, 4, 4, 2, 16, 8, 7, 3,
                                          "float32")
    base = _plain(q, kp, vp, tables, lens, "float32")
    kp[-1], vp[-1] = 1e4, -1e4
    got = _plain(q, kp, vp, tables, lens, "float32")
    np.testing.assert_array_equal(_np(base), _np(got))


def _split_partials(q, kp, vp, tables, lens, split):
    """The split kernel's arithmetic in float32: for each range of
    ``split`` key positions, each row's max score ``m`` over the keys it
    sees there, ``l`` and ``acc`` of exp(score - m) (zero where it sees
    none).  Returns m, l (B, W, Hq, n) and acc (B, W, Hq, n, D)."""
    B, W, Hq, D = q.shape
    _, ps, Hkv, _ = kp.shape
    P, G = tables.shape[1], Hq // Hkv
    n = -(-P * ps // split)
    k = kp[tables].reshape(B, P * ps, Hkv, D)
    v = vp[tables].reshape(B, P * ps, Hkv, D)
    s = np.einsum("bwhgd,bkhd->bwhgk", q.reshape(B, W, Hkv, G, D), k) \
        * D ** -0.5
    limit = lens[:, None] + np.arange(W)[None, :]                   # (B, W)
    seen = np.arange(P * ps)[None, None, :] < limit[..., None]      # (B, W, K)
    seen = np.broadcast_to(seen[:, :, None, None], s.shape)
    m = np.full((B, W, Hkv, G, n), -1e30, np.float32)
    l = np.zeros((B, W, Hkv, G, n), np.float32)
    acc = np.zeros((B, W, Hkv, G, n, D), np.float32)
    for i in range(n):
        cut = slice(i * split, (i + 1) * split)
        si, ok = s[..., cut], seen[..., cut]
        m[..., i] = np.where(ok, si, -1e30).max(-1)
        p = np.exp(np.where(ok, si - m[..., i:i + 1], -np.inf))
        l[..., i] = p.sum(-1)
        acc[..., i, :] = np.einsum("bwhgk,bkhd->bwhgd", p, v[:, cut])
    return (m.reshape(B, W, Hq, n), l.reshape(B, W, Hq, n),
            acc.reshape(B, W, Hq, n, D))


def _combine(m, l, acc):
    """The combine kernel's formula: splits with l > 0 weighted by
    e^(m_s - M), M their largest m; a row with none is zeros."""
    live = l > 0
    top = np.where(live, m, -np.inf).max(-1, keepdims=True)
    top = np.where(np.isfinite(top), top, 0.0)
    w = np.where(live, np.exp(np.where(live, m - top, 0.0)), 0.0)
    num = (w[..., None] * np.where(live[..., None], acc, 0.0)).sum(-2)
    return num / np.maximum((w * l).sum(-1), 1e-30)[..., None]


# (B, W, P, lengths): a split that holds no visible key (slot 0 ends in
# split 0 of 4), a dead slot, lengths on and beside a split edge (64 with
# W 1 ends exactly at the edge; 65 crosses it), W 64 at a deep position
SPLIT_CASES = [(2, 1, 16, [20, 0]), (3, 1, 8, [64, 65, 63]),
               (2, 4, 8, [61, 0]), (1, 64, 16, [150])]


@pytest.mark.parametrize("B,W,P,lengths", SPLIT_CASES)
def test_paged_attention_split_partials_merge_to_plain(B, W, P, lengths):
    """Partials over SPLIT_KEYS-position ranges of the keys, merged as the
    combine kernel merges them, equal the plain version (float32, 1e-5),
    with empty splits, a dead slot, split edges and W 64."""
    from repro_torch.kernels.paged_attention import SPLIT_KEYS
    rng = np.random.default_rng(B + W + P)
    Hq, Hkv, D, ps, N = 8, 2, 16, 16, 2 * P + 1
    q, kp, vp, tables, lens = _paged_case(rng, B, W, Hq, Hkv, D, ps, N, P,
                                          "float32")
    lens = np.asarray(lengths, np.int32)
    m, l, acc = _split_partials(q, kp, vp, tables, lens, SPLIT_KEYS)
    assert (l == 0).any()                       # some split sees no key
    got = _combine(m, l, acc)
    want = _np(_plain(q, kp, vp, tables, lens, "float32"))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if lens[-1] == 0:
        assert not got[-1, 0].any()             # dead slot: zero row 0


def test_paged_attention_split_count_reads_shapes_only():
    """One split while the table holds at most SPLIT_KEYS positions, then
    one more for each further SPLIT_KEYS; qwen2-7b's main path (32 pages
    of 16) has 8."""
    from repro_torch.kernels.paged_attention import SPLIT_KEYS, split_count
    assert SPLIT_KEYS == 64
    assert split_count(1, 16) == split_count(4, 16) == split_count(64, 1) == 1
    assert split_count(5, 16) == split_count(8, 16) == 2
    assert split_count(32, 16) == 8
    assert split_count(3, 7) == 1 and split_count(10, 7) == 2


def _int8_pages(rng, N, ps, Hkv, D):
    """int8 codes and positive float32 scales of one (N, ps, Hkv) page pool
    whose last page (the trash page) has zero codes and zero scales, as a
    fresh pool's."""
    codes = rng.integers(-127, 128, size=(N, ps, Hkv, D)).astype(np.int8)
    scale = rng.uniform(0.001, 0.05, size=(N, ps, Hkv)).astype(np.float32)
    codes[-1], scale[-1] = 0, 0.0
    return codes, scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("W", [1, 4, 16])
def test_paged_attention_int8_plain_matches_reference(W, dtype):
    """int8 pages with per-(row, head) scales: the port's plain version
    against the reference's oracle and its interpret-mode kernel, ragged
    lengths and a dead slot whose rows are zero."""
    rng = np.random.default_rng(20 + W)
    B, Hq, Hkv, D, ps, N, P = 3, 8, 2, 16, 8, 12, 4
    q = rng.normal(size=(B, W, Hq, D)).astype(np.float32)
    kc, ks = _int8_pages(rng, N, ps, Hkv, D)
    vc, vs = _int8_pages(rng, N, ps, Hkv, D)
    tables = rng.integers(0, N - 1, size=(B, P)).astype(np.int32)
    lens = np.array([P * ps - W + 1, 9, 0], np.int32)
    tables[-1] = N - 1                          # dead slot: the trash page
    qj, qt = _pair(q, dtype)
    got = ref.paged_attention_mq(
        qt, torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(tables), torch.from_numpy(lens),
        torch.from_numpy(ks), torch.from_numpy(vs))
    args = (jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(tables),
            jnp.asarray(lens), jnp.asarray(ks), jnp.asarray(vs))
    tol = 2e-4 if dtype == "float32" else 2e-2
    assert got.dtype == qt.dtype
    for want in (jref.paged_attention_mq(qj, *args),
                 jops.paged_attention_mq(qj, *args)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    assert not got[-1].any()                   # dead slot: every row zero


def test_paged_attention_int8_wrapper_routes_and_counts():
    """The counted wrapper takes int8 pages on the CPU route to the plain
    version, counts them under their own name, and refuses one scale
    without the other."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.normal(size=(2, 1, 4, 16)).astype(np.float32))
    kc, ks = (torch.from_numpy(a) for a in _int8_pages(rng, 5, 8, 2, 16))
    tb = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    ln = torch.tensor([9, 3], dtype=torch.int32)
    ops.reset_counts()
    out = ops.paged_attention_mq(q, kc, kc, tb, ln, ks, ks)
    assert ops.COUNTS["paged_attention_mq_int8"].plain == 1
    assert ops.COUNTS["paged_attention_mq"].plain == 0
    torch.testing.assert_close(out, ref.paged_attention_mq(q, kc, kc, tb, ln,
                                                           ks, ks))
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        ops.paged_attention_mq(q, kc, kc, tb, ln, ks, None)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

# the reference's kernel cases (tests/test_kernels.py)
FLASH_CASES = [
    (2, 256, 256, 4, 2, 32, True, None),     # GQA causal
    (1, 512, 512, 2, 2, 16, True, 100),      # sliding window
    (2, 256, 256, 4, 1, 32, False, None),    # bidirectional, MQA
    (1, 128, 128, 8, 8, 64, True, None),     # MHA
    (1, 384, 384, 2, 1, 32, True, 64),       # window + GQA, 3 tiles
]
# f32: summation order only; bf16: the reference's kernel-test limit
FLASH_TOL = {"float32": 2e-4, "bfloat16": 3e-2}


def _flash_inputs(rng, B, Sq, Sk, Hq, Hkv, D):
    return (rng.normal(size=(B, Sq, Hq, D)).astype(np.float32),
            rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window", FLASH_CASES)
def test_flash_attention_plain_matches_reference(B, Sq, Sk, Hq, Hkv, D,
                                                 causal, window, dtype):
    rng = np.random.default_rng(Sq + Hq + D)
    arrays = _flash_inputs(rng, B, Sq, Sk, Hq, Hkv, D)
    jq, jk, jv = (_pair(a, dtype)[0] for a in arrays)
    tq, tk, tv = (_pair(a, dtype)[1] for a in arrays)
    got = ref.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (B, Sq, Hq, D)
    want = jref.flash_attention(jq, jk, jv, causal=causal, window=window)
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_flash_attention_plain_matches_interpret_kernel():
    """Against the Pallas kernel itself (interpret mode), GQA causal."""
    rng = np.random.default_rng(8)
    q, k, v = _flash_inputs(rng, 2, 256, 256, 4, 2, 32)
    got = ref.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    want = jops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                q_blk=128, kv_blk=128)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)


def test_flash_attention_plain_ragged_length_and_keyless_rows():
    """A length that is no tile multiple matches the reference oracle; a
    row that sees no key (more queries than keys, with a window) is zeros,
    as in the kernel, where the oracle would average every key."""
    rng = np.random.default_rng(9)
    q, k, v = _flash_inputs(rng, 1, 200, 200, 4, 2, 16)
    got = ref.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              window=37)
    want = jref.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                window=37)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)
    q, k, v = _flash_inputs(rng, 1, 12, 4, 2, 1, 16)
    got = _np(ref.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=False, window=3))
    want = _np(jref.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                    causal=False, window=3))
    # row i sees keys j > i - 3, j < 4: rows 0..5 see some, 6.. none
    np.testing.assert_allclose(got[:, :6], want[:, :6], rtol=2e-4, atol=2e-4)
    assert not got[:, 6:].any()
    with pytest.raises(ValueError, match="window"):
        ref.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            window=0)


# ---------------------------------------------------------------------------
# wrapper routes and counters
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_route_and_count_it():
    rng = np.random.default_rng(5)
    q, kp, vp, tables, lens = _paged_case(rng, 2, 1, 4, 2, 16, 8, 6, 3,
                                          "float32")
    x = torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32))
    ops.reset_counts()
    ops.rmsnorm(x, torch.ones(16))
    ops.rmsnorm(x, torch.ones(16))
    ops.paged_attention_mq(*(torch.from_numpy(a)
                             for a in (q, kp, vp, tables, lens)))
    fq, fk, fv = _flash_inputs(rng, 1, 5, 5, 4, 2, 16)
    ops.flash_attention(*(torch.from_numpy(a) for a in (fq, fk, fv)))
    assert ops.COUNTS["rmsnorm"].plain == 2
    assert ops.COUNTS["paged_attention_mq"].plain == 1
    assert ops.COUNTS["flash_attention"].plain == 1
    assert all(c.kernel == 0 for c in ops.COUNTS.values())
    ops.reset_counts()
    assert all(c.kernel == c.plain == 0 for c in ops.COUNTS.values())


def test_counts_are_exact_under_threads():
    """The farm's worker threads bump the counters concurrently."""
    import threading
    x = torch.ones(2, 16)
    ops.reset_counts()

    def work():
        for _ in range(200):
            ops.rmsnorm(x, torch.ones(16))

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert ops.COUNTS["rmsnorm"].plain == 1600
    ops.reset_counts()
