"""The port's CUDA kernels on a card: each against its plain PyTorch version
at the served archs' shapes, the serving engine (paged and dense
per-slot, qwen2-7b and rwkv6-3b; qwen3-moe paged, placed and unplaced) on
the card through the kernels against the same engine on the CPU, the MoE
block over NCCL at world 1 against the serial block, the engine on a
serving mesh of one NCCL rank against the unmeshed engine, B1 at the
per-rank head shapes of tensor parallelism, zamba2's and gemma3's aligned
batches the same way, and training: B2's and B3's backward kernels against
autograd through their plain versions, a SMOKE trainer card == CPU.  Every test here needs a card
and skips with a reason where none is visible; the file imports no JAX, so
it runs on a card's host that has none:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.models.api import build_model
from repro_torch.models.module import tree_map
from repro_torch.serve import quant as QZ
from repro_torch.serve.engine import ServeEngine

pytestmark = pytest.mark.gpu

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# f32: summation order only; bf16: one rounding of the output (rmsnorm's
# outputs are O(1), attention's ~0.1, so its bf16 limit is tighter)
TOL = {"float32": 2e-4, "bfloat16": 2e-2}
ATTN_TOL = {"float32": 2e-4, "bfloat16": 1e-2}
# int8 pages: chip_smoke.py's limits
INT8_TOL = {"float32": 2e-4, "bfloat16": 4e-3}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _paged_case(rng, B, W, Hq, Hkv, D, ps, N, P, dead_slot):
    """Ragged lengths whose deepest row stays in the table; tables avoid
    the last page (the trash page); slot 0 full, the last slot dead."""
    q = rng.normal(size=(B, W, Hq, D)).astype(np.float32)
    kp = rng.normal(size=(N, ps, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(N, ps, Hkv, D)).astype(np.float32)
    tables = rng.integers(0, N - 1, size=(B, P)).astype(np.int32)
    lens = rng.integers(1, P * ps - W + 2, size=B).astype(np.int32)
    lens[0] = P * ps - W + 1
    if dead_slot:
        lens[-1] = 0
    return q, kp, vp, tables, lens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_kernel_matches_plain(card, dtype):
    rng = np.random.default_rng(6)
    for rows, d in ((1, 3584), (4097, 2048), (5, 128), (3, 100)):
        x = torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32))
        s = torch.from_numpy(rng.normal(size=(d,)).astype(np.float32))
        x, s = x.to(card, DTYPES[dtype]), s.to(card)
        got = ops.rmsnorm(x, s)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), ref.rmsnorm(x, s).float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])


# (rows, d) of the fused norms: the main paths' (decode 4, prefill chunk
# 64, dense prefill 1024, zamba2 prefill 4000; d 3584, gated d 7168), one
# row, and widths off the kernel's vector (8) or past its register rows
NORM_CASES = [(4, 3584), (64, 3584), (1024, 3584), (4000, 3584), (4, 7168),
              (4000, 7168), (1, 3584), (5, 1001), (3, 100), (2, 20000)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", NORM_CASES)
def test_add_rmsnorm_kernel_matches_plain(card, dtype, rows, d):
    """s bit for bit x + delta; y within rmsnorm's limits."""
    rng = np.random.default_rng(rows + d)
    x, dl = (torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32))
             .to(card, DTYPES[dtype]) for _ in range(2))
    scale = torch.from_numpy(rng.normal(size=(d,)).astype(np.float32)).to(
        card, DTYPES[dtype])
    s, y = ops.add_rmsnorm(x, dl, scale)
    torch.cuda.synchronize()
    want_s, want_y = ref.add_rmsnorm(x, dl, scale)
    assert s.dtype == y.dtype == x.dtype
    assert torch.equal(s, want_s)
    torch.testing.assert_close(y.float(), want_y.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("z_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", NORM_CASES)
def test_gated_rmsnorm_kernel_matches_plain(card, z_dtype, rows, d):
    rng = np.random.default_rng(rows + d + 1)
    y = torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32)).to(
        card)
    z = torch.from_numpy((2 * rng.normal(size=(rows, d))).astype(np.float32)
                         ).to(card, DTYPES[z_dtype])
    scale = torch.from_numpy(rng.normal(size=(d,)).astype(np.float32)).to(
        card, DTYPES[z_dtype])
    got = ops.gated_rmsnorm(y, z, scale)
    torch.cuda.synchronize()
    assert got.dtype == z.dtype
    torch.testing.assert_close(got.float(),
                               ref.gated_rmsnorm(y, z, scale).float(),
                               rtol=TOL[z_dtype], atol=TOL[z_dtype])


def test_fused_rmsnorm_kernels_count_and_read_strided_inputs(card):
    """One launch each under ``rmsnorm`` and its sub-count; a strided
    (transposed) input is made contiguous first."""
    x = torch.randn(8, 64, device=card).t()
    dl = torch.randn(64, 8, device=card)
    scale = torch.randn(8, device=card)
    ops.reset_counts()
    s, y = ops.add_rmsnorm(x, dl, scale)
    g = ops.gated_rmsnorm(x.contiguous(), dl, scale)
    torch.cuda.synchronize()
    assert torch.equal(s, x + dl)
    torch.testing.assert_close(y, ref.rmsnorm(x + dl, scale), rtol=2e-4,
                               atol=2e-4)
    torch.testing.assert_close(g, ref.gated_rmsnorm(x.contiguous(), dl,
                                                    scale),
                               rtol=2e-4, atol=2e-4)
    counts = {k: (c.kernel, c.plain) for k, c in ops.COUNTS.items()
              if c.kernel or c.plain}
    assert counts == {"rmsnorm": (2, 0), "rmsnorm_add": (1, 0),
                      "rmsnorm_gated": (1, 0)}
    ops.reset_counts()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", NORM_CASES)
def test_add_rmsnorm_kernel_without_the_sum(card, dtype, rows, d):
    """keep_sum=False (the models' final norm): s is not stored and comes
    back None, the norm is bit for bit the one beside a stored s, and the
    launch counts as a fused add."""
    rng = np.random.default_rng(rows + d + 2)
    x, dl = (torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32))
             .to(card, DTYPES[dtype]) for _ in range(2))
    scale = torch.from_numpy(rng.normal(size=(d,)).astype(np.float32)).to(
        card, DTYPES[dtype])
    ops.reset_counts()
    s, y = ops.add_rmsnorm(x, dl, scale, keep_sum=False)
    _, want = ops.add_rmsnorm(x, dl, scale)
    torch.cuda.synchronize()
    assert s is None
    assert torch.equal(y, want)
    assert (ops.COUNTS["rmsnorm_add"].kernel,
            ops.COUNTS["rmsnorm"].kernel) == (2, 2)
    ops.reset_counts()


def test_rmsnorm_wrappers_refuse_what_they_do_not_take(card):
    from repro_torch.kernels import rmsnorm as RN
    x = torch.randn(4, 64, device=card)
    s = torch.ones(64, device=card)
    with pytest.raises(TypeError):
        RN.add_rmsnorm_cuda(x, x.bfloat16(), s)          # mixed dtypes
    with pytest.raises(TypeError):
        RN.add_rmsnorm_cuda(x.half(), x.half(), s)       # float16
    with pytest.raises(ValueError):
        RN.add_rmsnorm_cuda(x, x[:2], s)                 # shapes differ
    with pytest.raises(ValueError):
        RN.add_rmsnorm_cuda(x, x.cpu(), s)               # not on one card
    with pytest.raises(ValueError):
        RN.add_rmsnorm_cuda(x, x, torch.ones(32, device=card))
    with pytest.raises(TypeError):
        RN.gated_rmsnorm_cuda(x.bfloat16(), x.bfloat16(), s)  # y not float32
    with pytest.raises(TypeError):
        RN.gated_rmsnorm_cuda(x, x.half(), s)
    with pytest.raises(ValueError):
        RN.gated_rmsnorm_cuda(x, x[:, :32], s)
    with pytest.raises(ValueError):
        RN.gated_rmsnorm_cuda(x, x, s.cpu())
    with pytest.raises(TypeError):
        RN.rmsnorm_cuda(x, s.half())                     # scale float16
    with pytest.raises(ValueError):
        RN.rmsnorm_cuda(x.cpu(), s)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hq,Hkv,W,B", [(28, 4, 1, 8), (28, 4, 64, 1),
                                        (16, 8, 5, 8), (4, 2, 3, 2)])
def test_paged_attention_kernel_matches_plain(card, dtype, Hq, Hkv, W, B):
    rng = np.random.default_rng(Hq + W + B)
    case = _paged_case(rng, B, W, Hq, Hkv, 128, 16, 40, 8, dead_slot=B > 1)
    q, kp, vp, tb, ln = (torch.from_numpy(a).to(card) for a in case)
    q, kp, vp = (t.to(DTYPES[dtype]) for t in (q, kp, vp))
    got = ops.paged_attention_mq(q, kp, vp, tb, ln)
    torch.cuda.synchronize()
    want = ref.paged_attention_mq(q, kp, vp, tb, ln)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=ATTN_TOL[dtype], atol=ATTN_TOL[dtype])
    if B > 1:
        assert not got[-1, 0].any()                # dead slot: zero row 0


def _int8_case(rng, card, dtype, B, W, Hq, Hkv, D, ps=16, N=40, P=8):
    """The float case's q, tables and lengths with int8 pages: normal K/V
    quantized per (row, head), the trash page (the last) all zero codes and
    zero scales, as in a fresh pool."""
    q, kp, vp, tb, ln = (torch.from_numpy(a).to(card) for a in _paged_case(
        rng, B, W, Hq, Hkv, D, ps, N, P, dead_slot=B > 1))
    kq, ks = QZ.Int8KVQuant().quantize(kp)
    vq, vs = QZ.Int8KVQuant().quantize(vp)
    for t in (kq, ks, vq, vs):
        t[-1] = 0
    return q.to(DTYPES[dtype]), kq, vq, tb, ln, ks, vs


# (Hq, Hkv, D, W, B): qwen2-7b's heads and the SMOKE configs', at decode,
# a verify width and a prefill chunk
INT8_CASES = [(28, 4, 128, 1, 4), (28, 4, 128, 4, 4), (28, 4, 128, 64, 1),
              (4, 2, 16, 1, 3), (4, 2, 16, 4, 3), (4, 2, 16, 64, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hq,Hkv,D,W,B", INT8_CASES)
def test_paged_attention_int8_kernel_matches_plain(card, dtype, Hq, Hkv, D,
                                                   W, B):
    rng = np.random.default_rng(Hq + D + W + B)
    q, kq, vq, tb, ln, ks, vs = _int8_case(rng, card, dtype, B, W, Hq, Hkv, D)
    ops.reset_counts()
    got = ops.paged_attention_mq(q, kq, vq, tb, ln, ks, vs)
    torch.cuda.synchronize()
    assert ops.COUNTS["paged_attention_mq_int8"].kernel == 1
    want = ref.paged_attention_mq(q, kq, vq, tb, ln, ks, vs)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=ATTN_TOL[dtype], atol=ATTN_TOL[dtype])
    if B > 1:
        assert not got[-1, 0].any()                # dead slot: zero row 0


# (B, W, Hq, Hkv, P, lengths): paged attention split over many ranges of
# 64 key positions: tables of 128 and 512 pages of 16, lengths on a split
# edge (64, 128) and beside it (63, 65, 129), a dead slot, W 64 deep in
# the table
SPLIT_CASES = [(4, 1, 28, 4, 128, (2000, 64, 65, 0)),
               (4, 1, 28, 4, 512, (8000, 63, 128, 129)),
               (2, 4, 28, 4, 128, (1500, 0)),
               (1, 64, 28, 4, 128, (1900,)),
               (1, 64, 16, 8, 512, (6000,))]


@pytest.mark.parametrize("pages", ["float", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,W,Hq,Hkv,P,lengths", SPLIT_CASES)
def test_paged_attention_split_kernel_matches_plain(card, pages, dtype, B, W,
                                                    Hq, Hkv, P, lengths):
    """The split kernel and its combine against the plain version over
    many key splits; every call counts as split; a dead slot is zero."""
    from repro_torch.kernels.paged_attention import split_count
    rng = np.random.default_rng(P + W + B)
    ps, D, N = 16, 128, 4 * P + 1                    # page N - 1: the trash
    q = rng.normal(size=(B, W, Hq, D)).astype(np.float32)
    kp = rng.normal(size=(N, ps, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(N, ps, Hkv, D)).astype(np.float32)
    kp[-1], vp[-1] = 1e4, -1e4
    tables = np.full((B, P), N - 1, np.int32)
    for b, n in enumerate(lengths):
        used = -(-(n + W - 1) // ps) if n else 0
        tables[b, :used] = rng.permutation(N - 1)[:used]
    q, kp, vp, tb, ln = (torch.from_numpy(a).to(card) for a in (
        q, kp, vp, tables, np.asarray(lengths, np.int32)))
    q = q.to(DTYPES[dtype])
    if pages == "int8":
        (kq, ks), (vq, vs) = (QZ.Int8KVQuant().quantize(t) for t in (kp, vp))
        args, tol = (kq, vq, tb, ln, ks, vs), INT8_TOL[dtype]
    else:
        args, tol = (kp.to(q.dtype), vp.to(q.dtype), tb, ln), ATTN_TOL[dtype]
    ops.reset_counts()
    got = ops.paged_attention_mq(q, *args)
    torch.cuda.synchronize()
    assert split_count(P, ps) > 1
    assert ops.COUNTS["paged_attention_mq_split"].kernel == 1
    torch.testing.assert_close(got.float(),
                               ref.paged_attention_mq(q, *args).float(),
                               rtol=tol, atol=tol)
    if 0 in lengths:
        assert not got[list(lengths).index(0), 0].any()


# (B, W, Hq, Hkv, D, P, N, lengths): whisper's decoder (G 1, D 64) at
# decode (a dead slot), at ngram verify windows of 3 and 5 and a 64-row
# chunk; llava's last image chunk 2880 deep and a decode ~2950 deep over
# tables of 188 pages
MM_PAGED = [(4, 1, 6, 6, 64, 8, 40, (80, 66, 93, 0)),
            (4, 3, 6, 6, 64, 8, 40, (45, 38, 57, 62)),
            (4, 5, 6, 6, 64, 8, 40, (45, 38, 57, 0)),
            (1, 64, 6, 6, 64, 8, 40, (1,)),
            (1, 64, 32, 8, 128, 188, 200, (2817,)),
            (4, 1, 32, 8, 128, 188, 760, (2950, 2941, 2962, 2933))]


@pytest.mark.parametrize("pages", ["float", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,W,Hq,Hkv,D,P,N,lengths", MM_PAGED)
def test_paged_attention_kernel_at_multimodal_shapes(card, pages, dtype, B,
                                                     W, Hq, Hkv, D, P, N,
                                                     lengths):
    rng = np.random.default_rng(Hq + W + P)
    q = torch.from_numpy(rng.normal(size=(B, W, Hq, D)).astype(np.float32))
    kp, vp = (torch.from_numpy(rng.normal(size=(N + 1, 16, Hkv, D))
                               .astype(np.float32)) for _ in range(2))
    tables = np.full((B, P), N, np.int32)          # page N: the trash page
    for b, n in enumerate(lengths):
        used = -(-(n + W - 1) // 16) if n else 0
        tables[b, :used] = rng.permutation(N)[:used]
    tb = torch.from_numpy(tables).to(card)
    ln = torch.tensor(lengths, dtype=torch.int32, device=card)
    q, kp, vp = (t.to(card, DTYPES[dtype]) for t in (q, kp, vp))
    if pages == "int8":
        (kq, ks), (vq, vs) = (QZ.Int8KVQuant().quantize(t.float())
                              for t in (kp, vp))
        args, tol = (kq, vq, tb, ln, ks, vs), INT8_TOL[dtype]
    else:
        args, tol = (kp, vp, tb, ln), ATTN_TOL[dtype]
    got = ops.paged_attention_mq(q, *args)
    torch.cuda.synchronize()
    want = ref.paged_attention_mq(q, *args)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if 0 in lengths:
        assert not got[list(lengths).index(0), 0].any()


def test_paged_attention_int8_wrapper_refuses_bad_scales(card):
    from repro_torch.kernels.paged_attention import paged_attention_mq_cuda
    rng = np.random.default_rng(9)
    q, kq, vq, tb, ln, ks, vs = _int8_case(rng, card, "bfloat16", 2, 1, 8, 2,
                                           128)
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        paged_attention_mq_cuda(q, kq, vq, tb, ln, ks, None)
    with pytest.raises(TypeError, match="want float32"):
        paged_attention_mq_cuda(q, kq, vq, tb, ln, ks.bfloat16(), vs)
    with pytest.raises(TypeError, match="int8 pages with k_scale"):
        paged_attention_mq_cuda(q, kq, vq, tb, ln)          # no scales at all
    q, kq, vq, tb, ln, ks, vs = _int8_case(rng, card, "bfloat16", 2, 1, 8, 2,
                                           24)
    with pytest.raises(ValueError, match="multiple of 16"):
        paged_attention_mq_cuda(q, kq, vq, tb, ln, ks, vs)


def test_int8_engine_on_card_matches_cpu(card):
    """SMOKE qwen2-7b in float32 with int8 KV pages and int8 weights: the
    card's engine runs the int8 kernel, never a plain version, and emits
    the CPU engine's greedy streams."""
    model = build_model(smoke_config("qwen2-7b"))
    cpu_params = model.init(0, device="cpu")
    prompts = [[5, 17, 33, 2, 9], [100, 200, 300], [7] * 11, list(range(40))]

    def serve(device):
        params = tree_map(lambda t: t.to(device), cpu_params)
        eng = ServeEngine(model, params, max_slots=3, max_len=128,
                          page_size=16, prefill_chunk=16, device=device,
                          kv_quant="int8", weight_quant="int8")
        for p in prompts:
            eng.submit(p, max_new_tokens=8)
        return {r.rid: r.output for r in eng.run_until_drained()}

    want = serve("cpu")
    ops.reset_counts()
    got = serve(card)
    assert ops.COUNTS["paged_attention_mq_int8"].kernel > 0
    assert ops.COUNTS["paged_attention_mq"].kernel == 0
    assert all(ops.COUNTS[k].plain == 0 for k in ops.COUNTS)
    assert got == want


# (B, Sq, Sk, Hq, Hkv, D, causal, window): causal, window, MQA/GQA/MHA,
# ragged lengths, every head width the kernel instantiates; qwen2-7b's
# heads at the dense prefill's buckets (1024, 2048) and a ragged 1000, and
# S 200 at D 64 with a window, which bf16 runs on the tensor cores; gemma3's
# D 256 (bf16 on the tensor cores, 64-key tiles): S 77 and 300, a window,
# non-causal, Sq != Sk both ways
FLASH_CASES = [(2, 256, 256, 4, 2, 32, True, None),
               (1, 512, 512, 2, 2, 16, True, 100),
               (2, 256, 256, 4, 1, 32, False, None),
               (1, 128, 128, 8, 8, 64, True, None),
               (1, 200, 200, 28, 4, 128, True, None),
               (2, 77, 77, 4, 1, 128, False, 19),
               (1, 300, 300, 4, 2, 256, True, 64),
               (1, 1, 1, 4, 2, 128, True, None),
               (1, 130, 90, 4, 2, 64, False, None),
               (1, 1024, 1024, 28, 4, 128, True, None),
               (1, 2048, 2048, 28, 4, 128, True, None),
               (1, 1000, 1000, 28, 4, 128, True, None),
               (1, 200, 200, 8, 2, 64, True, 48),
               (2, 300, 200, 28, 4, 128, True, None),
               # whisper's encoder (non-causal, 6/6 heads of 64): a chunk,
               # a clip's last chunk (32 frames, keys cut to the 28 valid),
               # a full chunk's keys cut to 28 and to 1, a whole clip;
               # llava's dense prefill (2880 image rows and 64 text)
               (1, 64, 64, 6, 6, 64, False, None),
               (1, 32, 28, 6, 6, 64, False, None),
               (1, 64, 28, 6, 6, 64, False, None),
               (1, 64, 1, 6, 6, 64, False, None),
               (1, 1500, 1500, 6, 6, 64, False, None),
               (1, 2944, 2944, 32, 8, 128, True, None),
               (1, 77, 77, 8, 4, 256, True, None),
               (1, 300, 300, 8, 4, 256, False, None),
               (1, 130, 90, 4, 2, 256, False, None),
               (1, 90, 130, 4, 2, 256, True, None)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,D,causal,window", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(card, dtype, B, Sq, Sk, Hq,
                                              Hkv, D, causal, window):
    rng = np.random.default_rng(Sq + D)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, H, D))
                                .astype(np.float32)).to(card, DTYPES[dtype])
               for S, H in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv)))
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=ATTN_TOL[dtype], atol=ATTN_TOL[dtype])


# (B, Sq, Sk, q_offset, Hq, Hkv, D, causal, window): training's sequence
# parallelism, a rank's queries at q_offset against the keys before its
# last one (Sk = q_offset + Sq): qwen3-1.7b's block of a 4 x 2048 sequence
# over 2 ranks, the same with a window, float32 at D 64 on CUDA cores
# (Sq 130 / Sk 260), an offset where Sk - Sq is no multiple of any tile,
# D 256 windowed, D 16; and offsets past the keys (rows that see none)
FLASH_OFFSET_CASES = [(1, 1024, 2048, 1024, 16, 8, 128, True, None),
                      (1, 1024, 2048, 1024, 16, 8, 128, True, 512),
                      (2, 130, 260, 130, 4, 2, 64, True, None),
                      (2, 200, 333, 133, 8, 4, 128, True, None),
                      (2, 200, 333, 133, 8, 4, 64, True, 100),
                      (1, 96, 300, 204, 4, 4, 256, True, 64),
                      (1, 96, 300, 204, 4, 4, 16, True, None),
                      (1, 64, 100, 300, 4, 2, 64, True, 50),
                      (2, 130, 90, 17, 4, 2, 128, False, None)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,off,Hq,Hkv,D,causal,window",
                         FLASH_OFFSET_CASES)
def test_flash_attention_kernel_with_offset_matches_plain(
        card, dtype, B, Sq, Sk, off, Hq, Hkv, D, causal, window):
    from repro_torch.kernels.flash_attention import flash_attention_plain
    rng = np.random.default_rng(Sq + D + off)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, H, D))
                                .astype(np.float32)).to(card, DTYPES[dtype])
               for S, H in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv)))
    ops.reset_counts()
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              q_offset=off)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, causal=causal, window=window,
                                 q_offset=off)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=ATTN_TOL[dtype], atol=ATTN_TOL[dtype])
    assert ops.COUNTS["flash_attention"].kernel == 1
    assert ops.COUNTS["flash_attention_tc"].kernel == int(
        dtype == "bfloat16" and D in (64, 128, 256))
    ops.reset_counts()


@pytest.mark.parametrize("dtype,D,tc", [("bfloat16", 64, True),
                                        ("bfloat16", 128, True),
                                        ("bfloat16", 32, False),
                                        ("bfloat16", 256, True),
                                        ("float32", 128, False)])
def test_flash_attention_route_follows_dtype_and_head_dim(card, dtype, D,
                                                          tc):
    """bf16 at D 64, 128 and 256 launches on the tensor cores (counted
    under flash_attention_tc), everything else on the CUDA cores."""
    rng = np.random.default_rng(D)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 70, H, D))
                                .astype(np.float32)).to(card, DTYPES[dtype])
               for H in (4, 2, 2))
    ops.reset_counts()
    got = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert ops.COUNTS["flash_attention"].kernel == 1
    assert ops.COUNTS["flash_attention_tc"].kernel == int(tc)
    torch.testing.assert_close(got.float(),
                               ref.flash_attention(q, k, v).float(),
                               rtol=ATTN_TOL[dtype], atol=ATTN_TOL[dtype])


def test_flash_attention_kernel_reads_strided_inputs(card):
    """q, k, v sliced out of one fused (B, S, H, D) buffer are read through
    their strides, with the same result as contiguous copies."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.normal(size=(2, 96, 12, 64))
                           .astype(np.float32)).to(card, torch.bfloat16)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    got = ops.flash_attention(q, k, v)
    want = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_dense_engine_on_card_matches_cpu(card):
    """SMOKE qwen2-7b in float32 on the dense per-slot path: the card's
    prefills run the flash-attention kernel (one launch a layer a prefill,
    from the farm's worker threads) and the streams equal the CPU's."""
    model = build_model(smoke_config("qwen2-7b"))
    cpu_params = model.init(0, device="cpu")
    prompts = [[5, 17, 33, 2, 9], [100, 200, 300], [7] * 11, list(range(40))]

    def serve(device):
        params = tree_map(lambda t: t.to(device), cpu_params)
        with ServeEngine(model, params, max_slots=3, max_len=128,
                         paged=False, prefill_workers=3,
                         device=device) as eng:
            for p in prompts:
                eng.submit(p, max_new_tokens=8)
            eng.run_until_drained()
        return {r.rid: r.output for r in eng.finished}, eng.stats

    want, _ = serve("cpu")
    ops.reset_counts()
    got, stats = serve(card)
    assert ops.COUNTS["flash_attention"].kernel \
        == model.cfg.n_layers * stats["prefills"]
    assert ops.COUNTS["rmsnorm"].kernel > 0
    assert all(c.plain == 0 for c in ops.COUNTS.values())
    assert got == want


def test_engine_on_card_matches_cpu(card):
    """SMOKE qwen2-7b in float32: the engine on the card, through both
    kernels and never their plain versions, emits the CPU engine's greedy
    streams."""
    model = build_model(smoke_config("qwen2-7b"))
    cpu_params = model.init(0, device="cpu")
    prompts = [[5, 17, 33, 2, 9], [100, 200, 300], [7] * 11, list(range(40))]

    def serve(device):
        params = tree_map(lambda t: t.to(device), cpu_params)
        eng = ServeEngine(model, params, max_slots=3, max_len=128,
                          page_size=16, prefill_chunk=16, device=device)
        for p in prompts:
            eng.submit(p, max_new_tokens=8)
        return {r.rid: r.output for r in eng.run_until_drained()}

    want = serve("cpu")
    ops.reset_counts()
    got = serve(card)
    paged_kernels = ("rmsnorm", "paged_attention_mq")
    assert all(ops.COUNTS[k].kernel > 0 for k in paged_kernels)
    assert all(ops.COUNTS[k].plain == 0 for k in ops.COUNTS)
    assert got == want


@pytest.mark.parametrize("arch,kw", [
    ("whisper-tiny", {}), ("whisper-tiny", {"kv_quant": "int8"}),
    ("llava-next-mistral-7b", {})])
def test_multimodal_engine_on_card_matches_cpu(card, arch, kw):
    """SMOKE whisper-tiny (float and int8 pages) and llava in float32: the
    engine on the card, through the kernels and never their plain
    versions, emits the CPU engine's greedy streams for requests with
    encoder payloads (whisper: B3 on the encoder; llava: a repeated image
    and a text request)."""
    model = build_model(smoke_config(arch))
    cfg = model.cfg
    cpu_params = model.init(0, device="cpu")
    rng = np.random.default_rng(5)
    n = cfg.n_audio_frames or cfg.n_image_tokens
    enc = [rng.normal(size=(n, cfg.d_model)).astype(np.float32)
           for _ in range(2)]
    reqs = [([5, 17, 33, 2, 9], enc[0]), ([100, 200, 300], enc[1]),
            ([7] * 11, enc[0])]
    if cfg.family == "vlm":
        reqs.append((list(range(20)), None))

    def serve(device):
        params = tree_map(lambda t: t.to(device), cpu_params)
        eng = ServeEngine(model, params, max_slots=2, max_len=64,
                          page_size=8, prefill_chunk=16, device=device, **kw)
        for p, e in reqs:
            eng.submit(p, max_new_tokens=8,
                       **({} if e is None else {"encoder_input": e}))
        out = {r.rid: r.output for r in eng.run_until_drained()}
        eng.close()
        return out

    want = serve("cpu")
    ops.reset_counts()
    got = serve(card)
    kernel = "flash_attention" if cfg.family == "audio" else "rmsnorm"
    assert ops.COUNTS[kernel].kernel > 0
    assert all(ops.COUNTS[k].plain == 0 for k in ops.COUNTS)
    assert got == want


# (B, S, H, K, V): the reference's three cases (K != V in the third), a
# ragged length, the full-width prefill and decode shapes of rwkv6-3b, and
# one step short of the tensor-core route's chunk (64), on it and past it
RWKV_CASES = [(2, 128, 3, 16, 16), (1, 64, 2, 8, 8), (1, 192, 1, 32, 16),
              (2, 200, 3, 64, 64), (1, 1024, 40, 64, 64), (4, 1, 40, 64, 64),
              (2, 63, 3, 64, 64), (2, 64, 3, 64, 64), (2, 65, 3, 64, 64)]
# both sides compute in float32 from the same (exactly widened) inputs and
# differ in summation order only: max |d| over max(1, max |plain|)
RWKV_REL = 1e-5


def _rwkv_case(rng, card, dtype, B, S, H, K, V, planted=0):
    """r, k, v in ``dtype``; the decay spans about e^-20 to 1, as
    exp(-exp(x)) with x ~ N(0, 1) gives it at full width, with ``planted``
    exact zeros and as many denormals put into it; u and a nonzero initial
    state."""
    f = np.float32
    r, k, v = (torch.from_numpy(rng.normal(size=(B, S, H, C)).astype(f))
               .to(card, DTYPES[dtype]) for C in (K, K, V))
    w = np.exp(-np.exp(rng.normal(size=(B, S, H, K)))).astype(f)
    if planted:
        flat = w.reshape(-1)
        at = rng.choice(flat.size, 2 * planted, replace=False)
        flat[at[:planted]] = 0.0
        flat[at[planted:]] = rng.uniform(1e-45, 1e-39, planted).astype(f)
    w = torch.from_numpy(w).to(card)
    u = torch.from_numpy(rng.normal(size=(H, K)).astype(f)).to(card)
    s0 = torch.from_numpy(rng.normal(size=(B, H, K, V)).astype(f)).to(card)
    return r, k, v, w, u, s0


def _rel_close(got, want, what):
    err = (got - want).abs().max().item()
    limit = RWKV_REL * max(1.0, want.abs().max().item())
    assert err <= limit, f"{what}: max abs err {err} > {limit}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,V", RWKV_CASES)
def test_rwkv6_scan_kernel_matches_plain(card, dtype, B, S, H, K, V):
    """y and the final state against the plain version; the state is
    written in place into ``state0`` (the decode step's use)."""
    rng = np.random.default_rng(S + K + V)
    r, k, v, w, u, s0 = _rwkv_case(rng, card, dtype, B, S, H, K, V)
    want_y, want_s = ref.rwkv6_scan(r, k, v, w, u, s0)
    state = s0.clone()
    ops.reset_counts()
    y, st = ops.rwkv6_scan(r, k, v, w, u, state, out_state=state)
    torch.cuda.synchronize()
    assert st is state and ops.COUNTS["rwkv6_scan"].kernel == 1
    # the tensor-core route takes K = V = 64 from one chunk (64 steps) on
    assert ops.COUNTS["rwkv6_scan_tc"].kernel \
        == int(K == V == 64 and S >= 64)
    _rel_close(y, want_y, "y")
    _rel_close(state, want_s, "state")
    y0, s_zero = ops.rwkv6_scan(r, k, v, w, u)            # zero state
    want_y0, want_s0 = ref.rwkv6_scan(r, k, v, w, u)
    _rel_close(y0, want_y0, "y from zeros")
    _rel_close(s_zero, want_s0, "state from zeros")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H", [(1, 256, 4), (2, 65, 3), (2, 63, 3)])
def test_rwkv6_scan_kernel_zero_and_denormal_decays(card, dtype, B, S, H):
    """Exact zeros and denormals in w (the full-width decay range has
    both) on either route: finite, and within RWKV_REL of the plain
    version, from a state written in place."""
    rng = np.random.default_rng(S + H)
    r, k, v, w, u, s0 = _rwkv_case(rng, card, dtype, B, S, H, 64, 64,
                                   planted=40)
    assert (w == 0).sum() == 40
    want_y, want_s = ref.rwkv6_scan(r, k, v, w, u, s0)
    state = s0.clone()
    y, _ = ops.rwkv6_scan(r, k, v, w, u, state, out_state=state)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    _rel_close(y, want_y, "y")
    _rel_close(state, want_s, "state")


def test_rwkv6_scan_wrapper_refuses_what_it_does_not_take(card):
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cuda
    rng = np.random.default_rng(4)
    r, k, v, w, u, s0 = _rwkv_case(rng, card, "bfloat16", 1, 8, 2, 24, 24)
    with pytest.raises(ValueError, match="key width K=24"):
        rwkv6_scan_cuda(r, k, v, w, u, s0)
    r, k, v, w, u, s0 = _rwkv_case(rng, card, "bfloat16", 1, 8, 2, 16, 16)
    with pytest.raises(TypeError, match="w is torch.bfloat16"):
        rwkv6_scan_cuda(r, k, v, w.bfloat16(), u, s0)
    with pytest.raises(TypeError, match="dtypes r="):
        rwkv6_scan_cuda(r, k.float(), v, w, u, s0)
    with pytest.raises(ValueError, match="want"):
        rwkv6_scan_cuda(r, k, v, w, u[:1], s0)


def test_rwkv_engine_on_card_matches_cpu(card):
    """SMOKE rwkv6-3b in float32 on the dense per-slot path (picked by
    itself): every layer's recurrence runs the wkv kernel, once a layer a
    prefill or decode step, never its plain version, and the streams equal
    the CPU's."""
    model = build_model(smoke_config("rwkv6-3b"))
    cpu_params = model.init(0, device="cpu")
    prompts = [[5, 17, 33, 2, 9], [100, 200, 300], [7] * 11, list(range(40)),
               [1, 2]]

    def serve(device):
        params = tree_map(lambda t: t.to(device), cpu_params)
        with ServeEngine(model, params, max_slots=3, max_len=128,
                         prefill_workers=3, device=device) as eng:
            assert not eng.paged
            for p in prompts:
                eng.submit(p, max_new_tokens=8)
            eng.run_until_drained()
        return {r.rid: r.output for r in eng.finished}, eng.stats

    want, _ = serve("cpu")
    ops.reset_counts()
    got, stats = serve(card)
    assert ops.COUNTS["rwkv6_scan"].kernel \
        == model.cfg.n_layers * (stats["prefills"] + stats["ticks"])
    assert all(c.plain == 0 for c in ops.COUNTS.values())
    assert all(c.kernel == 0 for n, c in ops.COUNTS.items()
               if n != "rwkv6_scan")
    assert got == want


# (B, S, H, P, N): the reference's three cases, a ragged length, the
# full-width prefill and decode shapes of zamba2-7b, and one step short of
# the tensor-core route's chunk (64), on it and past it
SSD_CASES = [(2, 256, 3, 16, 8), (1, 128, 2, 32, 16), (1, 512, 1, 8, 4),
             (2, 200, 3, 16, 8), (4, 1000, 112, 64, 64), (4, 1, 112, 64, 64),
             (2, 63, 8, 64, 64), (2, 64, 8, 64, 64), (2, 65, 8, 64, 64)]
# both sides compute in float32 from the same (exactly widened) inputs; the
# kernel's chunked form reassociates the decay products: max |d| over
# max(1, max |plain|) (a CPU mirror of its arithmetic gave 8.7e-7)
SSD_REL = 1e-5


def _ssd_case(rng, card, bc_dtype, B, S, H, P, N, decay=1.0):
    """zamba2's init statistics: dt = softplus(N(0, 1)), la = -decay dt
    (A_log 0 at decay 1), xdt = N(0, 1) * dt; B and C in ``bc_dtype``; a
    nonzero state."""
    f = np.float32
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H))))
    xdt = torch.from_numpy((rng.normal(size=(B, S, H, P)) * dt[..., None])
                           .astype(f)).to(card)
    la = torch.from_numpy((-decay * dt).astype(f)).to(card)
    bm, cm = (torch.from_numpy(rng.normal(size=(B, S, N)).astype(f))
              .to(card, DTYPES[bc_dtype]) for _ in range(2))
    s0 = torch.from_numpy(rng.normal(size=(B, H, N, P)).astype(f)).to(card)
    return xdt, la, bm, cm, s0


def _ssd_close(got, want, what):
    err = (got - want).abs().max().item()
    limit = SSD_REL * max(1.0, want.abs().max().item())
    assert err <= limit, f"{what}: max abs err {err} > {limit}"


@pytest.mark.parametrize("bc_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N", SSD_CASES)
def test_ssd_scan_kernel_matches_plain(card, bc_dtype, B, S, H, P, N):
    """y and the final state against the plain version: the state written
    in place into ``state0`` (the decode step's use), from a given state
    into a fresh one, and from zeros."""
    rng = np.random.default_rng(S + P + N)
    xdt, la, bm, cm, s0 = _ssd_case(rng, card, bc_dtype, B, S, H, P, N)
    want_y, want_s = ref.ssd_scan(xdt, la, bm, cm, s0)
    state = s0.clone()
    ops.reset_counts()
    y, st = ops.ssd_scan(xdt, la, bm, cm, state, out_state=state)
    torch.cuda.synchronize()
    assert st is state and ops.COUNTS["ssd_scan"].kernel == 1
    # the tensor-core route takes N = P = 64 with bf16 B/C from one chunk
    assert ops.COUNTS["ssd_scan_tc"].kernel == int(
        P == N == 64 and bc_dtype == "bfloat16" and S >= 64)
    _ssd_close(y, want_y, "y")
    _ssd_close(state, want_s, "state")
    y1, s1 = ops.ssd_scan(xdt, la, bm, cm, s0)
    _ssd_close(y1, want_y, "y, state given")
    _ssd_close(s1, want_s, "state, state given")
    y0, s_zero = ops.ssd_scan(xdt, la, bm, cm)
    want_y0, want_s0 = ref.ssd_scan(xdt, la, bm, cm)
    _ssd_close(y0, want_y0, "y from zeros")
    _ssd_close(s_zero, want_s0, "state from zeros")


@pytest.mark.parametrize("N", [4, 8, 16, 32, 64])
@pytest.mark.parametrize("P", [8, 16, 32, 64])
def test_ssd_scan_kernel_every_width(card, P, N):
    """Every (N, P) instantiation, over two chunks and a ragged third."""
    rng = np.random.default_rng(P * N)
    xdt, la, bm, cm, s0 = _ssd_case(rng, card, "bfloat16", 2, 70, 3, P, N)
    want_y, want_s = ref.ssd_scan(xdt, la, bm, cm, s0)
    y, st = ops.ssd_scan(xdt, la, bm, cm, s0)
    _ssd_close(y, want_y, "y")
    _ssd_close(st, want_s, "state")


@pytest.mark.parametrize("B,S,H", [(2, 1000, 5), (1, 300, 3)])
def test_ssd_scan_kernel_carries_state_across_segments(card, B, S, H):
    """A decay 200 times slower than zamba2's init keeps the state alive
    across the tensor-core route's segments of 256 steps, so the segment
    states and their composition show in y and the final state."""
    rng = np.random.default_rng(S + H)
    xdt, la, bm, cm, s0 = _ssd_case(rng, card, "bfloat16", B, S, H, 64, 64,
                                    decay=0.005)
    want_y, want_s = ref.ssd_scan(xdt, la, bm, cm, s0)
    state = s0.clone()
    ops.reset_counts()
    y, _ = ops.ssd_scan(xdt, la, bm, cm, state, out_state=state)
    torch.cuda.synchronize()
    assert ops.COUNTS["ssd_scan_tc"].kernel == 1
    _ssd_close(y, want_y, "y")
    _ssd_close(state, want_s, "state")


def test_ssd_scan_wrapper_refuses_what_it_does_not_take(card):
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    rng = np.random.default_rng(4)
    xdt, la, bm, cm, s0 = _ssd_case(rng, card, "bfloat16", 1, 8, 2, 24, 8)
    with pytest.raises(ValueError, match="head width P=24"):
        ssd_scan_cuda(xdt, la, bm, cm, s0)
    xdt, la, bm, cm, s0 = _ssd_case(rng, card, "bfloat16", 1, 8, 2, 16, 12)
    with pytest.raises(ValueError, match="state width N=12"):
        ssd_scan_cuda(xdt, la, bm, cm, s0)
    xdt, la, bm, cm, s0 = _ssd_case(rng, card, "bfloat16", 1, 8, 2, 16, 8)
    with pytest.raises(TypeError, match="xdt is torch.bfloat16"):
        ssd_scan_cuda(xdt.bfloat16(), la, bm, cm, s0)
    with pytest.raises(TypeError, match="dtypes Bm="):
        ssd_scan_cuda(xdt, la, bm, cm.float(), s0)
    with pytest.raises(ValueError, match="want"):
        ssd_scan_cuda(xdt, la[:, :4], bm, cm, s0)


def test_zamba_on_card_matches_cpu(card):
    """SMOKE zamba2-7b in float32 as an aligned batch: prefill, then
    decode steps at one position; every Mamba layer runs the SSD kernel
    once a prefill or step, never its plain version, and the greedy
    streams equal the CPU's."""
    model = build_model(smoke_config("zamba2-7b"))
    cpu_params = model.init(0, device="cpu")
    prompts = torch.tensor(np.random.default_rng(2).integers(
        0, model.cfg.vocab, (3, 9)).astype(np.int32))
    new = 8

    def greedy(device):
        params = tree_map(lambda t: t.to(device), cpu_params)
        state, hidden = model.prefill(params, prompts.to(device), 9 + new)
        tok = model.lm_head(params, hidden[:, -1:]).argmax(-1)
        out = [tok]
        for step in range(new - 1):
            tok = model.decode_step(params, state, tok.int(), 9 + step)\
                .argmax(-1)
            out.append(tok)
        return torch.cat(out, 1).cpu().tolist()

    want = greedy("cpu")
    ops.reset_counts()
    got = greedy(card)
    assert ops.COUNTS["ssd_scan"].kernel == model.cfg.n_layers * new
    assert all(c.plain == 0 for c in ops.COUNTS.values())
    assert all(c.kernel == 0 for n, c in ops.COUNTS.items()
               if n not in ("ssd_scan", "rmsnorm", "rmsnorm_add",
                            "rmsnorm_gated"))
    assert got == want


# ---------------------------------------------------------------------------
# speculative decode and seeded sampling on the card
# ---------------------------------------------------------------------------

# (B, W): the engine's verify windows at spec_k 4 (W 3 and 5, the half and
# the full window) over 4 slots, qwen2-7b's heads (W·G = 21 and 35 rows a
# KV head: the last 16-row tile partial), and the 32-page table of the main
# run, float and int8 pages
@pytest.mark.parametrize("pages", ["float", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("W", [3, 5])
def test_paged_attention_kernel_at_verify_widths(card, pages, dtype, W):
    rng = np.random.default_rng(W + len(dtype))
    if pages == "int8":
        q, kq, vq, tb, ln, ks, vs = _int8_case(rng, card, dtype, 4, W, 28, 4,
                                               128, N=160, P=32)
        args, tol = (q, kq, vq, tb, ln, ks, vs), ATTN_TOL[dtype]
        name = "paged_attention_mq_int8"
    else:
        case = _paged_case(rng, 4, W, 28, 4, 128, 16, 160, 32, dead_slot=True)
        q, kp, vp, tb, ln = (torch.from_numpy(a).to(card) for a in case)
        q, kp, vp = (t.to(DTYPES[dtype]) for t in (q, kp, vp))
        args, tol = (q, kp, vp, tb, ln), ATTN_TOL[dtype]
        name = "paged_attention_mq"
    ops.reset_counts()
    got = ops.paged_attention_mq(*args)
    torch.cuda.synchronize()
    assert ops.COUNTS[name].kernel == 1
    want = ref.paged_attention_mq(*args)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert not got[-1, 0].any()                    # dead slot: zero row 0


def test_prng_draws_on_card_match_cpu(card):
    """The threefry bits bit for bit, and so the uniforms, on the card and
    on the CPU (the full qwen2 vocab, a batch of rows)."""
    from repro_torch.serve import prng
    for seed in (0, 7, 2**31 - 1):
        k = prng.PRNGKey(seed)
        for shape in ((152064,), (4, 152064), (7,)):
            got = prng.bits(k, shape, device=card)
            assert torch.equal(got.cpu(), prng.bits(k, shape))
            assert torch.equal(prng.uniform(k, shape, device=card).cpu(),
                               prng.uniform(k, shape))


def _smoke_spec_streams(device, cpu_params, model, **kw):
    params = tree_map(lambda t: t.to(device), cpu_params)
    eng = ServeEngine(model, params, max_slots=3, max_len=128, page_size=16,
                      prefill_chunk=16, device=device, **kw)
    prompts = [[5, 17, 33, 5, 17, 33, 5, 17], [7] * 11, list(range(40))]
    for p in prompts:
        eng.submit(p, max_new_tokens=10)
    return {r.rid: r.output for r in eng.run_until_drained()}, eng


def test_spec_engine_on_card_matches_cpu(card):
    """SMOKE qwen2-7b in float32 with the 1-layer self-drafter: the verify
    windows through paged attention, the drafter through flash attention,
    never a plain version, and the CPU engine's greedy streams."""
    model = build_model(smoke_config("qwen2-7b"))
    cpu_params = model.init(0, device="cpu")
    want, _ = _smoke_spec_streams("cpu", cpu_params, model)
    ops.reset_counts()
    got, eng = _smoke_spec_streams(card, cpu_params, model,
                                   spec_decode="self-1")
    assert eng.stats["draft_proposed"] > 0
    for name in ("paged_attention_mq", "flash_attention", "rmsnorm"):
        assert ops.COUNTS[name].kernel > 0, name
    assert all(c.plain == 0 for c in ops.COUNTS.values())
    assert got == want


def test_drafter_kernel_failure_reaches_the_caller(card, monkeypatch):
    """A flash-attention launch that fails inside the self-drafter raises
    KernelError out of the engine's tick; it is never read as "no
    drafts"."""
    from repro_torch.kernels import build
    real = build.library()

    class FailingFlash:
        def __getattr__(self, name):
            return getattr(real, name)

        def flash_attention_launch(self, *args):
            return 1                               # cudaErrorInvalidValue

    monkeypatch.setattr(build, "library", lambda: FailingFlash())
    model = build_model(smoke_config("qwen2-7b"))
    cpu_params = model.init(0, device="cpu")
    ops.reset_counts()
    with pytest.raises(build.KernelError, match="flash_attention"):
        _smoke_spec_streams(card, cpu_params, model, spec_decode="self-1")
    assert ops.COUNTS["flash_attention"].kernel == 0


def test_drafter_wrapper_refusal_reaches_the_caller(card, monkeypatch):
    """The flash-attention wrapper refusing its input inside the
    self-drafter (here: no head dim accepted) raises its ValueError out of
    the engine's tick; it is never read as "no drafts"."""
    from repro_torch.kernels import flash_attention as fa
    monkeypatch.setattr(fa, "HEAD_DIMS", ())
    model = build_model(smoke_config("qwen2-7b"))
    cpu_params = model.init(0, device="cpu")
    ops.reset_counts()
    with pytest.raises(ValueError, match="flash_attention_cuda: head dim"):
        _smoke_spec_streams(card, cpu_params, model, spec_decode="self-1")
    assert ops.COUNTS["flash_attention"].kernel == 0
    assert ops.COUNTS["paged_attention_mq"].kernel > 0


# ---------------------------------------------------------------------------
# The science layer on the card: tensor keys, the three apps against the
# CPU, and the transport over NCCL at world 1
# ---------------------------------------------------------------------------

def test_tensor_keys_on_card_match_cpu(card):
    """split, fold_in and the uniform bits of a tensor key bit for bit the
    CPU's; the normals within erfinv's ulps (1e-5)."""
    from repro_torch.serve import prng
    for seed in (0, 7):
        k, kc = prng.PRNGKey(seed, device=card), prng.PRNGKey(seed,
                                                             device="cpu")
        assert torch.equal(prng.split(k, 5).cpu(), prng.split(kc, 5))
        assert torch.equal(prng.fold_in(k, 3).cpu(), prng.fold_in(kc, 3))
        assert torch.equal(prng.uniform(k, (700, 50)).cpu(),
                           prng.uniform(kc, (700, 50)))
        torch.testing.assert_close(prng.normal(k, (4096,)).cpu(),
                                   prng.normal(kc, (4096,)), rtol=0,
                                   atol=1e-5)


def test_gumbel_draws_on_a_card_keys_device(card):
    """A key on the card with no ``device``: the Gumbel draw lands on the
    card (it used to default to the CPU, a device mismatch), its values
    the CPU key's within the logs' ulps (1e-6)."""
    from repro_torch.serve import prng
    k, kc = prng.PRNGKey(3, device=card), prng.PRNGKey(3, device="cpu")
    got = prng.gumbel(k, (4096,))
    assert got.device == k.device
    torch.testing.assert_close(got.cpu(), prng.gumbel(kc, (4096,)), rtol=0,
                               atol=1e-6)


def test_mcmc_chain_on_card_matches_cpu(card):
    """The same key's chain on the card and the CPU: within the CPU
    test's limit against the reference (1e-3)."""
    from repro_torch.apps import mcmc
    from repro_torch.serve import prng
    y, _ = mcmc.make_synthetic_votes(prng.PRNGKey(2), 20, 40, device="cpu")
    yc, _ = mcmc.make_synthetic_votes(prng.PRNGKey(2), 20, 40, device=card)
    assert torch.equal(yc.cpu(), y)
    got, want = (mcmc.solve_vmap(mcmc.IdealPointProblem(
        yy, n_chains=2, n_iter=40, burn=20, seed=3)) for yy in (yc, y))
    torch.testing.assert_close(got["x_mean"].cpu(), want["x_mean"], rtol=0,
                               atol=1e-3)


def test_dmc_on_card_matches_cpu(card):
    """300 walkers, 50 steps: the population equal at every step, E_T
    within 1e-5."""
    from repro_torch.apps import dmc
    got = dmc.run_serial(300, 50, tau=0.02, seed=0, device=card)
    want = dmc.run_serial(300, 50, tau=0.02, seed=0, device="cpu")
    assert torch.equal(got["counts"].cpu(), want["counts"])
    torch.testing.assert_close(got["e_trial"].cpu(), want["e_trial"],
                               rtol=0, atol=1e-5)


def test_boussinesq_on_card_matches_cpu(card):
    """48 x 48, 20 steps: eta and phi within 1e-5, iterations equal."""
    from repro_torch.apps import boussinesq as bq
    p = bq.BoussinesqParams(nx=48, ny=48, dt=0.02, eps=0.3, alpha=0.05)
    got = bq.run_serial(p, 20, device=card)
    want = bq.run_serial(p, 20, device="cpu")
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-5)
    assert got[2]["iters"] == want[2]["iters"]


def _nccl_world1(comm, dev):
    """Collectives, the mesh executor and the Schwarz run over one NCCL
    rank, each against the same call on a Comm with no group."""
    from repro_torch.apps import boussinesq as bq
    from repro_torch.core.runtime import MeshExecutor
    x = torch.arange(24.0, device=dev).reshape(2, 3, 4)
    out = {"gather": comm.all_gather(x, axis=1),
           "sum": comm.all_reduce_sum(x), "max": comm.all_reduce_max(x),
           "a2a": comm.all_to_all(x, split_axis=1, concat_axis=0),
           "permute_self": comm.permute(x, [(0, 0)]),
           "permute_none": comm.permute(x, []),
           "broadcast": comm.broadcast_from(x),
           "mesh": MeshExecutor(comm).run(
               lambda: {"a": torch.arange(5.0, device=dev)},
               lambda t: t["a"] * 2, lambda o: o)}
    p = bq.BoussinesqParams(nx=32, ny=32, dt=0.02, eps=0.3, alpha=0.05)
    out["schwarz"] = bq.run_rank(comm, p, 5, device=dev)
    return out


def test_nccl_world1_transport_matches_alone(card, tmp_path):
    """A real NCCL group at world 1 (made and destroyed in this process)
    gives what a Comm with no group computes; no group is left behind."""
    from repro_torch.core.comm import Comm, run_ranks
    got = run_ranks(_nccl_world1, (card,), world=1, store_dir=tmp_path,
                    device=card)[0]
    assert not torch.distributed.is_initialized()
    want = _nccl_world1(Comm(), card)
    for k in ("gather", "sum", "max", "a2a", "permute_self", "permute_none",
              "broadcast", "mesh"):
        assert torch.equal(got[k], want[k].cpu()), k
    for g, w in zip(got["schwarz"][:2], want["schwarz"][:2]):
        torch.testing.assert_close(g, w.cpu(), rtol=0, atol=1e-6)
    assert got["schwarz"][2]["iters"] == want["schwarz"][2]["iters"]


def test_quickstart_on_card(card):
    """The parabola through the four executors on the card agrees with
    the host loop."""
    from repro_torch.launch import apps
    out = apps.quickstart(card)
    assert set(out["counts"].values()) == {out["counts"]["host"]}
    assert out["counts"]["host"] == 487


def test_run_ranks_refuses_more_nccl_ranks_than_cards(card, tmp_path):
    from repro_torch.core.comm import run_ranks
    with pytest.raises(RuntimeError, match="CUDA cards"):
        run_ranks(_nccl_world1, (card,), world=torch.cuda.device_count() + 1,
                  store_dir=tmp_path, device=card)


# -- disaggregated prefill/decode: the KV page handoff on the card ------------

@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_handoff_gather_inject_round_trip_on_card(card, kv_quant):
    """SMOKE qwen2-7b on the card: a prefill-only engine's packet holds its
    source pages bit for bit, and after ``inject_prefilled`` the decoder's
    pages hold the packet bit for bit (float and int8 pages with their
    scale leaves)."""
    from repro_torch.serve import pages as PG
    model = build_model(smoke_config("qwen2-7b"))
    params = model.init(0, device=card)
    kw = dict(max_slots=2, max_len=64, page_size=8, prefill_chunk=16,
              kv_quant=kv_quant, device=card)
    pre = ServeEngine(model, params, prefill_only=True, **kw)
    dec = ServeEngine(model, params, **kw)
    pre.submit(list(range(3, 24)), max_new_tokens=4)
    for _ in range(8):          # two chunks of 16, then the handoff
        if pre.handoffs:
            break
        pre.tick()
    packet = pre.handoffs.pop(0)
    n = -(-packet.length // 8)
    assert packet.length == 21 and len(packet.pages) == n
    table = torch.tensor([packet.pages], device=card)
    for name, st in pre.pool.storage.items():
        src = PG.gather_pages(st, table, n_prefix=1).squeeze(1)
        assert packet.kv[name].is_cuda
        assert torch.equal(packet.kv[name], src), name
    assert dec.inject_prefilled(packet)
    packet.release()
    slot = next(s for s in range(2) if dec.slot_req[s] is packet.req)
    table = torch.tensor([dec.sched.table[slot, :n].tolist()], device=card)
    for name, st in dec.pool.storage.items():
        got = PG.gather_pages(st, table, n_prefix=1).squeeze(1)
        assert torch.equal(got, packet.kv[name]), name
    assert dec.stats["kv_injections"] == 1 and pre.stats["kv_handoffs"] == 1


@pytest.mark.parametrize("executor", ["serial", "thread"])
def test_disagg_on_card_matches_monolithic_and_drains(card, executor):
    """SMOKE qwen2-7b in float32 on the card: the disaggregated engine's
    greedy streams equal the monolithic engine's on the card, through the
    kernels only, and both pools are whole after the drain."""
    from repro_torch.serve.disagg import DisaggServeEngine
    model = build_model(smoke_config("qwen2-7b"))
    params = model.init(0, device=card)
    prompts = [list(range(1, 20)), list(range(1, 20)), list(range(5, 40)),
               [2, 3, 4, 5, 6, 7, 8]]
    kw = dict(max_slots=3, max_len=64, page_size=8, num_pages=24,
              prefill_chunk=16, device=card)

    def serve(eng):
        for p in prompts:
            eng.submit(p, max_new_tokens=8)
        out = {r.rid: r.output for r in eng.run_until_drained()}
        return out

    with ServeEngine(model, params, **kw) as mono:
        want = serve(mono)
    ops.reset_counts()
    with DisaggServeEngine(model, params, executor=executor, **kw) as eng:
        got = serve(eng)
    assert got == want
    assert eng.stats["prefill"]["kv_handoffs"] == len(prompts)
    assert eng.stats["decode"]["kv_injections"] == len(prompts)
    for pool in (eng.prefiller.pool, eng.decoder.pool):
        assert pool.pages_in_use == 0
        assert pool.pages_free + pool.pages_cached == pool.num_pages
    for name in ("paged_attention_mq", "rmsnorm"):
        assert ops.COUNTS[name].kernel > 0, name
    assert all(c.plain == 0 for c in ops.COUNTS.values())


# -- the serial MoE path: expert parallelism and placement on the card --------

def _moe_ep_world1(comm, dev):
    """SMOKE qwen3-moe's block on the card over ``comm``, unplaced and under
    an ep-1 plan of its own counts."""
    import _torch_ranks as R
    from repro_torch.models import moe as M
    cfg, x, w = R.moe_inputs()
    out = {}
    for label, plan in (("unplaced", None),
                        ("placed", R.moe_plan(cfg, x, w, comm.size()))):
        params, placement = R.placed_block(w, plan)
        params = {k: v.to(dev) for k, v in params.items()}
        y, aux, stats = M.moe_apply_expert_parallel(
            params, torch.from_numpy(x).to(dev), cfg, comm,
            placement=None if placement is None else placement.to(dev))
        out[label] = {"y": y, "aux": aux, **stats}
    return out


def test_moe_expert_parallel_nccl_world1_matches_serial(card, tmp_path):
    """``moe_apply_expert_parallel`` over a real NCCL group at world 1
    equals the serial block on the card bit for bit (y, aux, telemetry),
    unplaced and placed."""
    from repro_torch.core.comm import SerialComm, run_ranks
    got = run_ranks(_moe_ep_world1, (card,), world=1, store_dir=tmp_path,
                    device=card)[0]
    want = _moe_ep_world1(SerialComm(), card)
    for label in ("unplaced", "placed"):
        for k in ("y", "aux", "tokens", "dropped"):
            assert torch.equal(got[label][k], want[label][k].cpu()), (label, k)


def test_moe_engine_on_card_placed_matches_unplaced_and_cpu(card):
    """SMOKE qwen3-moe (float32) through the paged engine on the card: the
    streams with the experts re-placed every 2 ticks equal the unplaced
    ones and the CPU engine's, with equal telemetry, through the kernels
    only."""
    model = build_model(smoke_config("qwen3-moe-235b-a22b"))
    cpu_params = model.init(0, device="cpu")
    prompts = [[5, 17, 33, 2, 9], [7] * 9, [1, 2, 3] * 4,
               [100, 200, 300, 4, 5, 6, 7]]

    def serve(device, **kw):
        params = tree_map(lambda t: t.to(device), cpu_params)
        with ServeEngine(model, params, max_slots=4, max_len=96,
                         page_size=16, prefill_chunk=32, device=device,
                         **kw) as eng:
            for p in prompts:
                eng.submit(p, max_new_tokens=6)
            out = {r.rid: r.output for r in eng.run_until_drained()}
        return out, eng.stats

    want, s_cpu = serve("cpu")
    ops.reset_counts()
    got, s_card = serve(card)
    placed, s_placed = serve(card, placement_interval=2)
    assert got == want == placed
    assert s_placed["placement_updates"] >= 1
    for k in ("moe_tokens_routed", "moe_dropped_tokens", "expert_tokens"):
        assert s_card[k] == s_cpu[k] == s_placed[k], k
    assert ops.COUNTS["paged_attention_mq"].kernel > 0
    assert all(c.plain == 0 for c in ops.COUNTS.values())


@pytest.mark.parametrize("Hq,Hkv,W,B", [(5, 1, 1, 4), (10, 2, 64, 1),
                                        (16, 1, 1, 4), (7, 1, 64, 1)])
def test_paged_attention_kernel_at_shard_shapes(card, Hq, Hkv, W, B):
    """B1 at the per-rank heads of tensor-parallel serving (qwen2.5-14b at
    tp 8 and 4, qwen3-moe at tp 4, qwen2-7b at tp 4), bf16, at decode and
    a 64-row chunk: few KV heads, so few blocks, against its plain
    version."""
    rng = np.random.default_rng(Hq * 7 + W)
    case = _paged_case(rng, B, W, Hq, Hkv, 128, 16, 40, 8, dead_slot=B > 1)
    q, kp, vp, tb, ln = (torch.from_numpy(a).to(card) for a in case)
    q, kp, vp = (t.to(torch.bfloat16) for t in (q, kp, vp))
    got = ops.paged_attention_mq(q, kp, vp, tb, ln)
    torch.cuda.synchronize()
    want = ref.paged_attention_mq(q, kp, vp, tb, ln)
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=ATTN_TOL["bfloat16"],
                               atol=ATTN_TOL["bfloat16"])


def _mesh_world1(comm, model, params, prompts, mesh_shape, names):
    from repro_torch.core.comm import make_mesh
    mesh = make_mesh(mesh_shape, names)
    with ServeEngine(model, params, max_slots=4, max_len=96, page_size=16,
                     prefill_chunk=32, device="cuda", mesh=mesh) as eng:
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        out = {r.rid: r.output for r in eng.run_until_drained()}
    return out, {k: eng.stats[k] for k in ("moe_tokens_routed",
                                           "expert_tokens", "tokens")}


@pytest.mark.parametrize("arch,shape,names", [
    ("qwen2-7b", (1,), ("model",)),
    ("qwen3-moe-235b-a22b", (1, 1), ("expert", "model"))])
def test_mesh_engine_world1_nccl_matches_unmeshed(card, tmp_path, arch,
                                                  shape, names):
    """The engine on a serving mesh of one NCCL rank (real groups of one,
    the all-reduces, the vocab gather and, for qwen3-moe, the all-to-all
    and the tiled expert gather all running) gives the unmeshed engine's
    streams and telemetry on the card, SMOKE float32."""
    from repro_torch.core.comm import run_ranks
    model = build_model(smoke_config(arch))
    params = model.init(0, device=card)
    prompts = [[5, 17, 33, 2, 9], [7] * 9, [1, 2, 3] * 4,
               [100, 200, 300, 4, 5, 6, 7]]
    got = run_ranks(_mesh_world1, (model, params, prompts, shape, names),
                    world=1, store_dir=tmp_path, device=card)[0]
    with ServeEngine(model, params, max_slots=4, max_len=96, page_size=16,
                     prefill_chunk=32, device=card) as eng:
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        want = {r.rid: r.output for r in eng.run_until_drained()}
    assert got[0] == want
    for k in got[1]:
        assert got[1][k] == eng.stats[k], k


# -- training (ROADMAP A13a): the backward kernels, gemma3, a trainer -------

# B2's backward: the rows and widths of training (QK-norms d 128 and 256,
# qwen3-1.7b 2048, gemma3 2560), one row, a width off every vector
BWD_NORM_CASES = [(4096, 128), (640, 256), (8192, 2048), (1000, 2560),
                  (1, 2048), (7, 100)]
# max |d| over max(1, max |autograd|): float32 summation order; bf16 the
# gradient rounded once to bf16 (one ulp 2**-7 of O(1) values) where the
# float32 autograd rounds none
BWD_TOL = {"float32": 2e-4, "bfloat16": 3e-2}


def _grads(fn, *tensors, cot):
    leaves = [t.detach().clone().requires_grad_(True) for t in tensors]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward([o for o in outs if o is not None],
                            [c for o, c in zip(outs, cot) if o is not None])
    return [t.grad for t in leaves]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", BWD_NORM_CASES)
def test_rmsnorm_backward_kernels_match_autograd(card, dtype, rows, d):
    """rmsnorm and the fused add (its sum read on, and not), on the card
    through the backward kernel, against autograd through the plain
    versions in float32 on the same inputs."""
    from repro_torch.kernels.rmsnorm import (add_rmsnorm_plain,
                                             rmsnorm_plain)
    rng = np.random.default_rng(rows + d)
    dt = DTYPES[dtype]

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape))
                                .astype(np.float32)).to(card)
    x, delta, gy, gs = (t(rows, d).to(dt) for _ in range(4))
    s = 1 + t(d, scale=0.1)
    tol = BWD_TOL[dtype]
    ops.reset_counts()
    got = _grads(ops.rmsnorm, x, s, cot=(gy,))
    want = _grads(rmsnorm_plain, x.float(), s, cot=(gy.float(),))
    for g, w in zip(got, want):
        err = (g.float() - w).abs().max().item()
        assert err <= tol * max(1.0, w.abs().max().item()), err
    for keep in (True, False):
        got = _grads(lambda a, b, c: ops.add_rmsnorm(a, b, c, keep_sum=keep),
                     x, delta, s, cot=(gs, gy))
        want = _grads(lambda a, b, c: add_rmsnorm_plain(a, b, c,
                                                        keep_sum=keep),
                      x.float(), delta.float(), s,
                      cot=(gs.float(), gy.float()))
        for g, w in zip(got, want):
            err = (g.float() - w).abs().max().item()
            assert err <= tol * max(1.0, w.abs().max().item()), (keep, err)
    torch.cuda.synchronize()
    assert ops.COUNTS["rmsnorm_bwd"].kernel == 3
    assert ops.COUNTS["rmsnorm_add_bwd"].kernel == 2
    assert ops.COUNTS["rmsnorm"].plain == 0
    ops.reset_counts()


# (B, S, Hq, Hkv, D, causal, window): SMOKE, qwen3-1.7b's heads at D 128,
# gemma3's 8/4 at D 256 windowed, a ragged S, bidirectional, G 4 windowed
# at D 128; bf16 at D 64, 128 and 256 takes the tensor cores
BWD_FLASH_CASES = [(2, 64, 4, 2, 16, True, None), (1, 100, 4, 1, 32, True, 8),
                   (1, 257, 16, 8, 128, True, None),
                   (1, 300, 8, 4, 256, True, 64),
                   (2, 77, 2, 2, 64, False, None),
                   (1, 300, 16, 4, 128, True, 64),
                   # whisper's training heads (G 1, D 64): the encoder's
                   # non-causal S 1500 (23 tiles of 64 and a ragged 28), a
                   # ragged S 100, the decoder's causal S 448
                   (2, 1500, 6, 6, 64, False, None),
                   (3, 100, 6, 6, 64, False, None),
                   (2, 448, 6, 6, 64, True, None)]
# dq/dk/dv are sums over keys (queries) of O(1) terms: float32 within
# 1e-4 of the largest, bf16 within 2e-2 (inputs, output and dO rounded to
# bf16 on the card's side only)
BWD_ATTN_REL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,off,Hq,Hkv,D,causal,window",
                         FLASH_OFFSET_CASES)
def test_flash_attention_backward_kernel_with_offset_matches_autograd(
        card, dtype, B, Sq, Sk, off, Hq, Hkv, D, causal, window):
    """FLASH_OFFSET_CASES' backward against autograd through the plain
    version in float32; bf16 at D 64/128 on the tensor cores."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    rng = np.random.default_rng(Sq + D + off)
    dt = DTYPES[dtype]

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(card, dt)
    q, k, v, g = t(B, Sq, Hq, D), t(B, Sk, Hkv, D), t(B, Sk, Hkv, D), \
        t(B, Sq, Hq, D)
    ops.reset_counts()
    kw = dict(causal=causal, window=window, q_offset=off)
    got = _grads(lambda a, b, c: ops.flash_attention(a, b, c, **kw),
                 q, k, v, cot=(g,))
    want = _grads(lambda a, b, c: flash_attention_plain(a, b, c, **kw),
                  q.float(), k.float(), v.float(), cot=(g.float(),))
    torch.cuda.synchronize()
    for gg, w, name in zip(got, want, ("dq", "dk", "dv")):
        err = (gg.float() - w).abs().max().item()
        assert err <= BWD_ATTN_REL[dtype] * max(1.0, w.abs().max().item()), \
            (name, err)
    assert ops.COUNTS["flash_attention_bwd"].kernel == 1
    assert ops.COUNTS["flash_attention_bwd_tc"].kernel == int(
        dtype == "bfloat16" and D in (64, 128, 256))
    assert ops.COUNTS["flash_attention"].plain == 0
    ops.reset_counts()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal,window", BWD_FLASH_CASES)
def test_flash_attention_backward_kernel_matches_autograd(
        card, dtype, B, S, Hq, Hkv, D, causal, window):
    from repro_torch.kernels.flash_attention import flash_attention_plain
    rng = np.random.default_rng(S + D)
    dt = DTYPES[dtype]

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(card, dt)
    q, k, v, g = t(B, S, Hq, D), t(B, S, Hkv, D), t(B, S, Hkv, D), \
        t(B, S, Hq, D)
    ops.reset_counts()
    got = _grads(lambda a, b, c: ops.flash_attention(a, b, c, causal=causal,
                                                     window=window),
                 q, k, v, cot=(g,))
    want = _grads(lambda a, b, c: flash_attention_plain(
        a, b, c, causal=causal, window=window), q.float(), k.float(),
        v.float(), cot=(g.float(),))
    torch.cuda.synchronize()
    for gg, w, name in zip(got, want, ("dq", "dk", "dv")):
        err = (gg.float() - w).abs().max().item()
        assert err <= BWD_ATTN_REL[dtype] * max(1.0, w.abs().max().item()), \
            (name, err)
    assert ops.COUNTS["flash_attention_bwd"].kernel == 1
    assert ops.COUNTS["flash_attention_bwd_tc"].kernel == int(
        dtype == "bfloat16" and D in (64, 128, 256))
    assert ops.COUNTS["flash_attention"].plain == 0
    ops.reset_counts()


# B3's backward at bf16 D 256 on the tensor cores (gemma3's heads; dk and
# dv in blocks of their own): (B, Sq, Sk, q_offset, Hq, Hkv, causal,
# window): gemma3's windowed and global layers at S 2048, a 64 window at
# G 1, ragged S at G 2, a query offset, bidirectional
BWD_D256_CASES = [(1, 2048, 2048, 0, 8, 4, True, 1024),
                  (1, 2048, 2048, 0, 8, 4, True, None),
                  (2, 300, 300, 0, 4, 4, True, 64),
                  (1, 1000, 1000, 0, 8, 4, True, None),
                  (1, 257, 257, 0, 2, 1, True, 100),
                  (1, 200, 333, 133, 8, 4, True, None),
                  (1, 130, 130, 0, 4, 2, False, None)]


@pytest.mark.parametrize("B,Sq,Sk,off,Hq,Hkv,causal,window", BWD_D256_CASES)
def test_flash_attention_backward_d256_on_tensor_cores(
        card, B, Sq, Sk, off, Hq, Hkv, causal, window):
    """bf16 D 256 through the autograd Function: the forward writes the
    log-sum-exp, the backward takes the tensor cores; against autograd
    through the plain version in float32, and two runs the same bits."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    rng = np.random.default_rng(Sq + Sk + off)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(card, torch.bfloat16)
    q, k, v, g = t(B, Sq, Hq, 256), t(B, Sk, Hkv, 256), \
        t(B, Sk, Hkv, 256), t(B, Sq, Hq, 256)
    kw = dict(causal=causal, window=window, q_offset=off)
    ops.reset_counts()
    got = _twice(lambda a, b, c: ops.flash_attention(a, b, c, **kw),
                 q, k, v, cot=(g,))
    want = _grads(lambda a, b, c: flash_attention_plain(a, b, c, **kw),
                  q.float(), k.float(), v.float(), cot=(g.float(),))
    torch.cuda.synchronize()
    _within(got, want, BWD_ATTN_REL["bfloat16"], "flash_attention_bwd D 256")
    assert ops.COUNTS["flash_attention_bwd"].kernel == 2
    assert ops.COUNTS["flash_attention_bwd_tc"].kernel == 2
    assert ops.COUNTS["flash_attention"].plain == 0
    ops.reset_counts()


def test_flash_attention_backward_routes_at_d256(card):
    """At bf16 D 256 the CUDA-core kernels run only when asked for by
    ``tensor_cores=False``; both routes agree with autograd.  Elsewhere
    a route the rule does not give is refused."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda,
        flash_attention_plain)
    rng = np.random.default_rng(256)

    def t(*shape, dt=torch.bfloat16):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(card, dt)
    q, k, v, g = t(1, 300, 8, 256), t(1, 300, 4, 256), t(1, 300, 4, 256), \
        t(1, 300, 8, 256)
    out, lse = flash_attention_cuda(q, k, v, window=64, with_lse=True)
    want = _grads(lambda a, b, c: flash_attention_plain(a, b, c, window=64),
                  q.float(), k.float(), v.float(), cot=(g.float(),))
    tc = flash_attention_bwd_cuda(q, k, v, out, g, window=64, lse=lse)
    cuda = flash_attention_bwd_cuda(q, k, v, out, g, window=64,
                                    tensor_cores=False)
    torch.cuda.synchronize()
    _within(tc, want, BWD_ATTN_REL["bfloat16"], "tensor cores")
    _within(cuda, want, BWD_ATTN_REL["bfloat16"], "CUDA cores")
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd_cuda(q, k, v, out, g, window=64)
    q2, k2 = t(1, 64, 4, 128), t(1, 64, 2, 128)
    o2, l2 = flash_attention_cuda(q2, k2, k2, with_lse=True)
    with pytest.raises(ValueError, match="no CUDA-core route"):
        flash_attention_bwd_cuda(q2, k2, k2, o2, q2, tensor_cores=False)
    q3, k3 = t(1, 64, 4, 256, dt=torch.float32), t(1, 64, 2, 256,
                                                   dt=torch.float32)
    o3 = flash_attention_cuda(q3, k3, k3)
    with pytest.raises(ValueError, match="no tensor-core route"):
        flash_attention_bwd_cuda(q3, k3, k3, o3, q3, tensor_cores=True)


# B2's backward on both layouts: a block a row at training's wide d
# (zamba2's gated 7168, its 3584, qwen3-1.7b's 2048) and a warp a row at
# the QK-norm's 128, each at a row count no multiple of a block's rows
NORM_LAYOUT_CASES = [(1000, 7168), (333, 3584), (4097, 2048), (999, 128)]


@pytest.mark.parametrize("rows,d", NORM_LAYOUT_CASES)
def test_norm_backward_layouts_match_autograd_twice(card, rows, d):
    """The norm, the fused add (its sum read on and not) and the gated
    norm in bf16 through their backward kernels, each run twice (the same
    bits), against autograd through the plain versions in float32."""
    from repro_torch.kernels.rmsnorm import add_rmsnorm_plain, rmsnorm_plain
    rng = np.random.default_rng(rows * 7 + d)

    def t(*shape, dt=torch.bfloat16):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(card, dt)
    x, delta, gy, gs, z = (t(rows, d) for _ in range(5))
    y = t(rows, d, dt=torch.float32)
    s = 1 + 0.1 * t(d, dt=torch.float32)
    tol = BWD_TOL["bfloat16"]
    ops.reset_counts()
    got = _twice(ops.rmsnorm, x, s, cot=(gy,))
    want = _grads(rmsnorm_plain, x.float(), s, cot=(gy.float(),))
    _within(got, want, tol, "rmsnorm_bwd")
    for keep in (True, False):
        got = _twice(lambda a, b, c: ops.add_rmsnorm(a, b, c, keep_sum=keep),
                     x, delta, s, cot=(gs, gy))
        want = _grads(lambda a, b, c: add_rmsnorm_plain(a, b, c,
                                                        keep_sum=keep),
                      x.float(), delta.float(), s,
                      cot=(gs.float(), gy.float()))
        _within(got, want, tol, f"add_rmsnorm_bwd keep_sum={keep}")
    got = _twice(ops.gated_rmsnorm, y, z, s, cot=(gy,))
    want = _grads(ref.gated_rmsnorm, y, z.float(), s, cot=(gy.float(),))
    _within(got, want, tol, "gated_rmsnorm_bwd")
    torch.cuda.synchronize()
    assert ops.COUNTS["rmsnorm_bwd"].kernel == 8
    assert ops.COUNTS["rmsnorm_add_bwd"].kernel == 4
    assert ops.COUNTS["rmsnorm_gated_bwd"].kernel == 2
    assert ops.COUNTS["rmsnorm"].plain == 0
    ops.reset_counts()


def test_kernels_without_backward_refuse_grad(card):
    """Paged attention, the one kernel without a backward, refuses a
    gradient on a card."""
    rng = np.random.default_rng(0)
    q, kp, vp, tb, ln = _paged_case(rng, 2, 1, 4, 2, 16, 8, 6, 3, False)
    q, kp, vp, tb, ln = (torch.from_numpy(t).to(card)
                         for t in (q, kp, vp, tb, ln))
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.paged_attention_mq(q.requires_grad_(True), kp, vp, tb, ln)
    # flash attention with Sq != Sk (a query offset) has its backward
    # kernel: it runs, it does not refuse
    ops.reset_counts()
    q = torch.ones(1, 2, 2, 16, device=card, requires_grad=True)
    out = ops.flash_attention(q, torch.ones(1, 3, 2, 16, device=card),
                              torch.ones(1, 3, 2, 16, device=card),
                              q_offset=1)
    out.sum().backward()
    torch.cuda.synchronize()
    assert ops.COUNTS["flash_attention_bwd"].kernel == 1
    assert q.grad is not None and torch.isfinite(q.grad).all()
    ops.reset_counts()


# -- training of the recurrent families (ROADMAP A13b item 4): the scans'
# and the gated norm's backward kernels, B3 at head dim 112 --------------

# max |d| over max(1, max |autograd|) against autograd through the plain
# version in float32 on the same (widened) inputs: float32 differs by
# summation order only, bf16 by one rounding of the gradient to bf16
SCAN_BWD_TOL = {"float32": 1e-5, "bfloat16": 4e-3}


def _twice(fn, *tensors, cot):
    """:func:`_grads` twice: the same bits both times; the first."""
    a, b = (_grads(fn, *tensors, cot=cot) for _ in range(2))
    assert all(torch.equal(x, y) for x, y in zip(a, b)), "runs differ"
    return a


def _within(got, want, tol, what):
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs().max().item()
        assert err <= tol * max(1.0, w.float().abs().max().item()), \
            (what, err)


# (B, S, H, K, V, planted zeros and denormals in w): the CUDA-core route
# (other widths, S one short of a chunk) and the chunk-parallel
# tensor-core route (K = V = 64 from one chunk: a chunk edge, one past it, a
# ragged length, two whole chunks)
RWKV_BWD_CASES = [(2, 70, 3, 16, 16, 0), (1, 33, 2, 32, 8, 0),
                  (1, 63, 2, 64, 64, 4), (2, 64, 2, 64, 64, 8),
                  (1, 65, 2, 64, 64, 8), (1, 200, 3, 64, 64, 8),
                  (2, 256, 2, 64, 64, 16)]
# (B, S, H, P, N): the CUDA-core route (other widths, S one short of a
# chunk, and every float32 B/C) and the tensor-core route (N = P = 64 with
# bf16 B/C from one chunk; H 10 and 9: two groups of heads, the last short)
SSD_BWD_CASES = [(2, 70, 3, 16, 8), (1, 40, 2, 8, 4), (1, 63, 2, 64, 64),
                 (1, 64, 2, 64, 64), (1, 65, 2, 64, 64),
                 (2, 200, 10, 64, 64), (1, 256, 9, 64, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,V,planted", RWKV_BWD_CASES)
def test_rwkv6_scan_backward_kernel_matches_autograd(card, dtype, B, S, H,
                                                     K, V, planted):
    """B4's backward (every input's gradient, the state's too, the final
    state's cotangent included) against autograd through the plain
    version on either route; decays at 0 and denormal planted; two runs
    the same bits; the tensor-core route counted as ``rwkv6_scan_bwd_tc``,
    no plain call."""
    rng = np.random.default_rng(S + K + V)
    ins = _rwkv_case(rng, card, dtype, B, S, H, K, V, planted)
    cot = (torch.randn(B, S, H, V, device=card),
           torch.randn(B, H, K, V, device=card))
    ops.reset_counts()
    got = _twice(ops.rwkv6_scan, *ins, cot=cot)
    want = _grads(ref.rwkv6_scan, *(t.float() for t in ins), cot=cot)
    torch.cuda.synchronize()
    _within(got, want, SCAN_BWD_TOL[dtype], "rwkv6_scan_bwd")
    tc = int(K == V == 64 and S >= 64)
    assert ops.COUNTS["rwkv6_scan_bwd"].kernel == 2
    assert ops.COUNTS["rwkv6_scan_bwd_tc"].kernel == 2 * tc
    assert ops.COUNTS["rwkv6_scan"].kernel == 2
    assert all(c.plain == 0 for c in ops.COUNTS.values())


@pytest.mark.parametrize("bc_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,P,N", SSD_BWD_CASES)
def test_ssd_scan_backward_kernel_matches_autograd(card, bc_dtype, B, S, H,
                                                   P, N):
    """B5's backward (dB and dC summed over the heads) against autograd
    through the plain version on either route; two runs the same bits;
    the tensor-core route counted as ``ssd_scan_bwd_tc``, no plain
    call."""
    rng = np.random.default_rng(S + P + N)
    ins = _ssd_case(rng, card, bc_dtype, B, S, H, P, N)
    cot = (torch.randn(B, S, H, P, device=card),
           torch.randn(B, H, N, P, device=card))
    ops.reset_counts()
    got = _twice(ops.ssd_scan, *ins, cot=cot)
    want = _grads(ref.ssd_scan, *(t.float() for t in ins), cot=cot)
    torch.cuda.synchronize()
    _within(got, want, SCAN_BWD_TOL[bc_dtype], "ssd_scan_bwd")
    tc = int(P == N == 64 and S >= 64 and bc_dtype == "bfloat16")
    assert ops.COUNTS["ssd_scan_bwd"].kernel == 2
    assert ops.COUNTS["ssd_scan_bwd_tc"].kernel == 2 * tc
    assert ops.COUNTS["ssd_scan"].kernel == 2
    assert all(c.plain == 0 for c in ops.COUNTS.values())


def test_scan_backward_routes_agree(card):
    """Both routes of each scan's backward at a shape the tensor-core
    route takes (``tensor_cores=False`` forces the CUDA-core one, as
    chip_smoke.py's timing does) against autograd through the plain
    version; the tensor-core route refuses a shape outside its rule."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_bwd_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda
    rng = np.random.default_rng(30)
    r, k, v, w, u, s0 = _rwkv_case(rng, card, "bfloat16", 1, 130, 2, 64, 64,
                                   4)
    gy = torch.randn(1, 130, 2, 64, device=card)
    gs = torch.randn(1, 2, 64, 64, device=card)
    want = _grads(ref.rwkv6_scan, *(t.float() for t in (r, k, v, w, u, s0)),
                  cot=(gy, gs))
    for tc in (True, False):
        got = rwkv6_scan_bwd_cuda(r, k, v, w, u, s0, gy, gs, tensor_cores=tc)
        _within(got, want, SCAN_BWD_TOL["bfloat16"], f"rwkv6 tc={tc}")
    with pytest.raises(ValueError, match="no tensor-core route"):
        rwkv6_scan_bwd_cuda(r[:, :63], k[:, :63], v[:, :63], w[:, :63], u,
                            s0, gy[:, :63], gs, tensor_cores=True)
    xdt, la, bm, cm, s1 = _ssd_case(rng, card, "bfloat16", 1, 130, 9, 64, 64)
    gy = torch.randn(1, 130, 9, 64, device=card)
    gs = torch.randn(1, 9, 64, 64, device=card)
    want = _grads(ref.ssd_scan, *(t.float() for t in (xdt, la, bm, cm, s1)),
                  cot=(gy, gs))
    for tc in (True, False):
        got = ssd_scan_bwd_cuda(xdt, la, bm, cm, s1, gy, gs, tensor_cores=tc)
        _within(got, want, SCAN_BWD_TOL["bfloat16"], f"ssd tc={tc}")
    with pytest.raises(ValueError, match="no tensor-core route"):
        ssd_scan_bwd_cuda(xdt, la, bm.float(), cm.float(), s1, gy, gs,
                          tensor_cores=True)


@pytest.mark.parametrize("z_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", [(64, 128), (7, 1001), (300, 7168)])
def test_gated_rmsnorm_backward_kernel_matches_autograd(card, z_dtype, rows,
                                                        d):
    """The gated norm's backward (dy, dz, dscale) against autograd through
    the plain version in float32; two runs the same bits."""
    rng = np.random.default_rng(rows + d)
    y = torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32)) \
        .to(card)
    z, g = (torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32))
            .to(card, DTYPES[z_dtype]) for _ in range(2))
    scale = 1 + 0.1 * torch.randn(d, device=card)
    ops.reset_counts()
    got = _twice(ops.gated_rmsnorm, y, z, scale, cot=(g,))
    want = _grads(ref.gated_rmsnorm, y, z.float(), scale, cot=(g.float(),))
    torch.cuda.synchronize()
    _within(got, want, BWD_TOL[z_dtype], "gated_rmsnorm_bwd")
    assert ops.COUNTS["rmsnorm_gated_bwd"].kernel == 2
    assert ops.COUNTS["rmsnorm_bwd"].kernel == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_head_dim_112_zero_padded(card, dtype):
    """B3 at zamba2's head dim 112, zero-padded to 128 (bf16 on the tensor
    cores both ways), forward and backward against the plain version."""
    rng = np.random.default_rng(112)
    q, k, v, g = (torch.from_numpy(rng.normal(size=(2, 130, 4, 112))
                                   .astype(np.float32)).to(card, DTYPES[dtype])
                  for _ in range(4))
    ops.reset_counts()
    out = ops.flash_attention(q, k, v)
    want = ref.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert out.shape == q.shape
    torch.testing.assert_close(out.float(), want.float(),
                               rtol=ATTN_TOL[dtype], atol=ATTN_TOL[dtype])
    got = _grads(ops.flash_attention, q, k, v, cot=(g,))
    want_g = _grads(ref.flash_attention, q.float(), k.float(), v.float(),
                    cot=(g.float(),))
    _within(got, want_g, BWD_ATTN_REL[dtype], "flash_attention_bwd D 112")
    tc = int(dtype == "bfloat16")
    assert ops.COUNTS["flash_attention_bwd"].kernel == 1
    assert ops.COUNTS["flash_attention_bwd_tc"].kernel == tc
    assert ops.COUNTS["flash_attention_tc"].kernel == 2 * tc


# the heads a rank's scan takes when rwkv6-3b (40 heads) and zamba2-7b
# (112) train over a mesh of tp 2 and 4: whole heads over every position
# (zamba2's 28 is not a multiple of B5's backward's groups of 8)
RANK_SCAN_CASES = [("rwkv6", 20), ("rwkv6", 10), ("ssd", 56), ("ssd", 28)]


@pytest.mark.parametrize("kind,H", RANK_SCAN_CASES)
def test_scans_at_mesh_rank_heads(card, kind, H):
    """B4 and B5 at the per-rank head counts of training over a mesh, bf16
    inputs at K = V = 64 and N = P = 64 (S 256, two rows): forward and
    backward against the plain version (autograd in float32 for the
    backward), every call on the tensor-core route both ways."""
    rng = np.random.default_rng(H)
    B, S = 2, 256
    if kind == "rwkv6":
        ins = _rwkv_case(rng, card, "bfloat16", B, S, H, 64, 64, 0)[:5]
        fn, plain = ops.rwkv6_scan, ref.rwkv6_scan
    else:
        ins = _ssd_case(rng, card, "bfloat16", B, S, H, 64, 64)[:4]
        fn, plain = ops.ssd_scan, ref.ssd_scan
    cot = (torch.randn(B, S, H, 64, device=card),)
    ops.reset_counts()
    y = fn(*ins)[0]
    want_y = plain(*ins)[0]
    torch.cuda.synchronize()
    _within([y], [want_y], RWKV_REL if kind == "rwkv6" else SSD_REL,
            f"{kind} forward")
    got = _grads(lambda *a: fn(*a)[0], *ins, cot=cot)
    want = _grads(lambda *a: plain(*a)[0], *(t.float() for t in ins),
                  cot=cot)
    torch.cuda.synchronize()
    _within(got, want, SCAN_BWD_TOL["bfloat16"], f"{kind}_scan_bwd H={H}")
    name = f"{kind}_scan"
    assert ops.COUNTS[name].kernel == ops.COUNTS[f"{name}_tc"].kernel == 2
    assert ops.COUNTS[f"{name}_bwd"].kernel == 1
    assert ops.COUNTS[f"{name}_bwd_tc"].kernel == 1
    assert all(c.plain == 0 for c in ops.COUNTS.values())


def test_flash_attention_d112_with_offset(card):
    """B3 as a rank's shared block of zamba2 runs it when the sequence is
    split over tp 2: the second block's queries (offset 256) over every
    key before them, 32/32 heads of 112 zero-padded to 128, bf16 on the
    tensor cores both ways, against the plain version."""
    rng = np.random.default_rng(1120)
    B, Sq, Sk, off, H, D = 1, 256, 512, 256, 32, 112

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
            .to(card, torch.bfloat16)
    q, k, v, g = t(B, Sq, H, D), t(B, Sk, H, D), t(B, Sk, H, D), \
        t(B, Sq, H, D)
    ops.reset_counts()
    out = ops.flash_attention(q, k, v, q_offset=off)
    want = ref.flash_attention(q, k, v, q_offset=off)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(),
                               rtol=ATTN_TOL["bfloat16"],
                               atol=ATTN_TOL["bfloat16"])
    got = _grads(lambda a, b, c: ops.flash_attention(a, b, c, q_offset=off),
                 q, k, v, cot=(g,))
    want_g = _grads(lambda a, b, c: ref.flash_attention(a, b, c,
                                                        q_offset=off),
                    q.float(), k.float(), v.float(), cot=(g.float(),))
    _within(got, want_g, BWD_ATTN_REL["bfloat16"], "B3 D 112 q_offset")
    assert ops.COUNTS["flash_attention_tc"].kernel == 2
    assert ops.COUNTS["flash_attention_bwd"].kernel == 1
    assert ops.COUNTS["flash_attention_bwd_tc"].kernel == 1
    assert all(c.plain == 0 for c in ops.COUNTS.values())


def test_gemma3_aligned_batch_on_card_matches_cpu(card):
    """SMOKE gemma3-4b (float32): prefill then 12 aligned decode steps past
    the ring's wrap, greedy, card == CPU."""
    model = build_model(smoke_config("gemma3-4b"))
    cpu_params = model.init(0, device="cpu")
    card_params = tree_map(lambda t: t.to(card), cpu_params)
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, model.cfg.vocab, (2, 11)).astype(np.int32))
    outs = []
    for params, dev in ((cpu_params, "cpu"), (card_params, card)):
        cache, hidden = model.prefill(params, prompts.to(dev), 24)
        tok = model.lm_head(params, hidden[:, -1:]).argmax(-1)
        toks = [tok]
        for step in range(12):
            tok = model.decode_step(params, cache, tok.int(), 11 + step) \
                .argmax(-1)
            toks.append(tok)
        outs.append(torch.cat(toks, 1).cpu())
    assert torch.equal(outs[0], outs[1])


def test_smoke_trainer_on_card_matches_cpu(card):
    """Three float32 SMOKE qwen3-1.7b trainer steps on the card (B2 and B3
    backward kernels) against the CPU from the same weights and batches."""
    from repro_torch.data import SyntheticTask, make_data_iter
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig
    model = build_model(smoke_config("qwen3-1.7b"))
    params = model.init(0, device="cpu", dtype=torch.float32)
    hist = {}
    for dev in ("cpu", card):
        ops.reset_counts()
        tr = Trainer(model, AdamWConfig(peak_lr=1e-3, warmup_steps=1,
                                        decay_steps=3),
                     TrainerConfig(steps=3, log_every=100),
                     make_data_iter(SyntheticTask(model.cfg, 4, 32),
                                    device=dev),
                     device=dev, params=params, log=lambda s: None)
        hist[str(dev)] = tr.fit()["history"]
    assert ops.COUNTS["flash_attention_bwd"].kernel == 3 * model.cfg.n_layers
    assert ops.COUNTS["rmsnorm_bwd"].kernel > 0
    assert all(c.plain == 0 for c in ops.COUNTS.values())
    ops.reset_counts()
    for a, b in zip(hist["cpu"], hist["cuda"]):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-3)



def _mm_batch(model, B, S, dev):
    from repro_torch.data import SyntheticTask
    batch = SyntheticTask(model.cfg, batch=B, seq_len=S, seed=1).batch_at(0)
    return {k: v.to(dev) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "whisper-tiny"])
def test_multimodal_loss_and_grads_on_card_match_cpu(card, arch):
    """float32 SMOKE llava and whisper: the loss and every gradient leaf on
    the card (B2's and B3's kernels both ways, whisper's plain cross read)
    against the CPU's plain route, from the same weights and batch."""
    from repro_torch.models.module import tree_leaves
    model = build_model(smoke_config(arch))
    params = model.init(0, device="cpu", dtype=torch.float32)
    out = {}
    for dev in ("cpu", card):
        ops.reset_counts()
        p = tree_map(lambda t: t.to(dev).requires_grad_(True), params)
        loss, _ = model.loss(p, _mm_batch(model, 4, 24, dev))
        grads = torch.autograd.grad(loss, tree_leaves(p))
        out[str(dev)] = (loss.item(), [g.cpu() for g in grads])
    assert ops.COUNTS["flash_attention_bwd"].kernel > 0
    assert all(c.plain == 0 for c in ops.COUNTS.values())
    ops.reset_counts()
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    assert lg == pytest.approx(lc, rel=1e-5)
    _within(gg, gc, 1e-4, f"{arch} gradients card vs CPU")


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "whisper-tiny"])
def test_multimodal_bf16_step_on_tensor_cores(card, arch):
    """One bf16 trainer step of a narrow llava and whisper at head dim 64:
    B3 on the tensor cores both ways (llava's B2 too), whisper's cross read
    through the float32-result product with its gradient, no plain
    version; the loss within bf16 rounding of the CPU's, every gradient
    finite."""
    from repro_torch.data import make_data_iter, SyntheticTask
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig
    cfg = smoke_config(arch).replace(dtype="bfloat16", d_model=256,
                                     n_heads=4, head_dim=64)
    if arch.startswith("llava"):
        cfg = cfg.replace(n_kv_heads=2)
    else:
        cfg = cfg.replace(n_kv_heads=4)
    model = build_model(cfg)
    params = model.init(0, device="cpu", dtype=torch.float32)
    hist = {}
    for dev in ("cpu", card):
        ops.reset_counts()
        tr = Trainer(model, AdamWConfig(peak_lr=1e-3, warmup_steps=1,
                                        decay_steps=2),
                     TrainerConfig(steps=2, log_every=100),
                     make_data_iter(SyntheticTask(cfg, 4, 40, seed=1),
                                    device=dev),
                     device=dev, params=params, log=lambda s: None)
        hist[str(dev)] = tr.fit()["history"]
    layers = cfg.n_layers + (cfg.decoder_layers if arch == "whisper-tiny"
                             else 0)
    assert ops.COUNTS["flash_attention_tc"].kernel == 2 * 2 * layers
    assert ops.COUNTS["flash_attention_bwd_tc"].kernel == 2 * layers
    if arch.startswith("llava"):
        assert ops.COUNTS["rmsnorm_bwd"].kernel > 0
    assert all(c.plain == 0 for c in ops.COUNTS.values())
    ops.reset_counts()
    for a, b in zip(hist["cpu"], hist["cuda"]):
        assert np.isfinite(b["grad_norm"])
        assert b["loss"] == pytest.approx(a["loss"], rel=2e-2)
