"""Gradients of the training path's kernels (B2: RMSNorm and its fused
residual add; B3: flash attention) on the CPU, on numpy-seeded inputs:

* autograd through the port's plain versions (the CPU route of
  ``repro_torch.kernels.ops`` under autograd, and the backward kernels'
  oracle on the card) against ``jax.grad`` of the reference's functions
  (``repro.kernels.ref``, the x + delta the reference's blocks add before
  their norms): causal, sliding-window, bidirectional and GQA cases, and
  queries at an offset against ``repro.models.attention.gqa_attention(
  q_offset=)`` (sequence parallelism's blocks);
* the backward kernels' arithmetic mirrored in float64 numpy (B2: the row
  formula and the scale's gradient summed over per-block partials; B3: the
  log-sum-exp recomputed, ``rowsum(dO * O)``, dS, and dk/dv summed over a
  KV head's query heads) against the same autograd, so the formulas the
  CUDA sources implement are checked here, where no card runs them.

Tolerances: float32 on both sides, summation order only: 1e-5 of the
largest magnitude compared (at least 1) for the norms, 2e-5 for attention
(a softmax's gradient sums over the keys); the float64 mirrors 1e-5 of the
float32 autograd they are held against.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain

NORM_REL, ATTN_REL, MIRROR_REL = 1e-5, 2e-5, 1e-5


def _close(got, want, rel, what):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    limit = rel * max(1.0, float(np.abs(want).max()))
    assert err <= limit, f"{what}: max abs err {err} > {limit}"


def _leaf(a):
    return torch.tensor(a, requires_grad=True)


# ---------------------------------------------------------------------------
# B2
# ---------------------------------------------------------------------------

NORM_CASES = [(7, 16), (12, 128), (3, 2560)]


@pytest.mark.parametrize("rows,d", NORM_CASES)
def test_rmsnorm_grad_matches_jax(rows, d):
    rng = np.random.default_rng(rows * d)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=d)).astype(np.float32)
    gy = rng.normal(size=(rows, d)).astype(np.float32)
    jdx, jds = jax.grad(lambda x, s: jnp.sum(jref.rmsnorm(x, s) * gy),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(scale))
    tx, ts = _leaf(x), _leaf(scale)
    ops.reset_counts()
    (ops.rmsnorm(tx, ts) * torch.from_numpy(gy)).sum().backward()
    assert ops.COUNTS["rmsnorm"].plain == 1
    assert ops.COUNTS["rmsnorm_bwd"].kernel == 0       # no card here
    _close(tx.grad, jdx, NORM_REL, f"rmsnorm dx {rows}x{d}")
    _close(ts.grad, jds, NORM_REL, f"rmsnorm dscale {rows}x{d}")


@pytest.mark.parametrize("rows,d,keep_sum", [(9, 64, True), (4, 2048, False)])
def test_add_rmsnorm_grad_matches_jax(rows, d, keep_sum):
    """The fused add's gradient: the sum's own cotangent (when the stream
    is read on) plus the norm's, to both addends."""
    rng = np.random.default_rng(rows + d)
    x, delta, gy, gs = (rng.normal(size=(rows, d)).astype(np.float32)
                        for _ in range(4))
    scale = (1 + 0.1 * rng.normal(size=d)).astype(np.float32)
    w_s = 1.0 if keep_sum else 0.0

    def f(x, delta, s):
        v = x + delta
        return jnp.sum(jref.rmsnorm(v, s) * gy) + w_s * jnp.sum(v * gs)

    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray,
                                               (x, delta, scale)))
    tx, td, ts = _leaf(x), _leaf(delta), _leaf(scale)
    s, y = ops.add_rmsnorm(tx, td, ts, keep_sum=keep_sum)
    assert (s is None) == (not keep_sum)
    loss = (y * torch.from_numpy(gy)).sum()
    if keep_sum:
        loss = loss + (s * torch.from_numpy(gs)).sum()
    loss.backward()
    for got, w, name in zip((tx.grad, td.grad, ts.grad), want,
                            ("dx", "ddelta", "dscale")):
        _close(got, w, NORM_REL, f"add_rmsnorm {name} {rows}x{d}")


def _rmsnorm_bwd_mirror(v, dy, ds, scale, eps=1e-6, rows_per_block=5):
    """csrc/rmsnorm.cu's backward in float64: the row formula, and dscale
    as the sum of per-block partials (``rows_per_block`` rows a block)."""
    r = 1 / np.sqrt((v * v).mean(-1, keepdims=True) + eps)
    dot = (dy * scale * v).mean(-1, keepdims=True)
    dv = r * (dy * scale - v * r * r * dot)
    if ds is not None:
        dv = dv + ds
    terms = dy * v * r
    parts = [terms[i:i + rows_per_block].sum(0)
             for i in range(0, len(v), rows_per_block)]
    return dv, np.sum(parts, axis=0)


@pytest.mark.parametrize("with_ds", [False, True])
def test_rmsnorm_backward_formula(with_ds):
    rng = np.random.default_rng(5)
    v, dy, ds = (rng.normal(size=(23, 128)) for _ in range(3))
    scale = 1 + 0.1 * rng.normal(size=128)
    tv, ts = _leaf(v.astype(np.float32)), _leaf(scale.astype(np.float32))
    y = ops.rmsnorm(tv, ts)
    torch.autograd.backward(y, torch.tensor(dy, dtype=torch.float32))
    dv, dscale = _rmsnorm_bwd_mirror(v, dy, ds if with_ds else None, scale)
    want_dv = tv.grad.double().numpy() + (ds if with_ds else 0)
    _close(dv, want_dv, MIRROR_REL, "mirror dv")
    _close(dscale, ts.grad, MIRROR_REL, "mirror dscale")


# ---------------------------------------------------------------------------
# B3
# ---------------------------------------------------------------------------

# (B, S, Hq, Hkv, D, causal, window)
ATTN_CASES = [(2, 24, 4, 2, 16, True, None),      # GQA 2, causal
              (1, 40, 4, 1, 32, True, 8),         # GQA 4, windowed
              (2, 17, 2, 2, 16, False, None),     # bidirectional, ragged
              (1, 33, 8, 4, 64, True, 5)]


def _attn_inputs(B, S, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
            for _ in range(2))
    g = rng.normal(size=(B, S, Hq, D)).astype(np.float32)
    return q, k, v, g


@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_flash_attention_grad_matches_jax(case):
    B, S, Hq, Hkv, D, causal, window = case
    q, k, v, g = _attn_inputs(B, S, Hq, Hkv, D, S)
    want = jax.grad(
        lambda q, k, v: jnp.sum(jref.flash_attention(
            q, k, v, causal=causal, window=window) * g),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _leaf(q), _leaf(k), _leaf(v)
    ops.reset_counts()
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    (out * torch.from_numpy(g)).sum().backward()
    assert ops.COUNTS["flash_attention"].plain == 1
    for got, w, name in zip((tq.grad, tk.grad, tv.grad), want,
                            ("dq", "dk", "dv")):
        _close(got, w, ATTN_REL, f"flash attention {name} {case}")


def _flash_bwd_mirror(q, k, v, o, g, causal, window, q_offset=0):
    """csrc/flash_attention_bwd.cu in float64: lse recomputed, delta =
    rowsum(dO * O), dS = P (dP - delta); dq from every key, dk and dv
    summed over the G query heads of each KV head; query row i at position
    q_offset + i."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5
    i = q_offset + np.arange(Sq)[:, None]
    j = np.arange(Sk)[None, :]
    ok = np.ones((Sq, Sk), bool)
    if causal:
        ok &= j <= i
    if window is not None:
        ok &= i - j < window
    dq, dk, dv = np.zeros_like(q), np.zeros_like(k), np.zeros_like(v)
    for b in range(B):
        for h in range(Hq):
            hk = h // G
            s = scale * q[b, :, h] @ k[b, :, hk].T
            m = np.where(ok, s, -np.inf).max(-1, keepdims=True)
            lse = m + np.log(np.where(ok, np.exp(s - m), 0).sum(-1,
                                                               keepdims=True))
            p = np.where(ok, np.exp(s - lse), 0.0)
            delta = (g[b, :, h] * o[b, :, h]).sum(-1, keepdims=True)
            dp = g[b, :, h] @ v[b, :, hk].T
            ds = p * (dp - delta)
            dq[b, :, h] = scale * ds @ k[b, :, hk]
            dk[b, :, hk] += scale * ds.T @ q[b, :, h]
            dv[b, :, hk] += p.T @ g[b, :, h]
    return dq, dk, dv


@pytest.mark.parametrize("case", ATTN_CASES[:3], ids=str)
def test_flash_attention_backward_formula(case):
    B, S, Hq, Hkv, D, causal, window = case
    q, k, v, g = _attn_inputs(B, S, Hq, Hkv, D, 7 * S)
    tq, tk, tv = _leaf(q), _leaf(k), _leaf(v)
    out = flash_attention_plain(tq, tk, tv, causal=causal, window=window)
    (out * torch.from_numpy(g)).sum().backward()
    got = _flash_bwd_mirror(*(a.astype(np.float64) for a in (
        q, k, v, out.detach().numpy(), g)), causal, window)
    for m, t, name in zip(got, (tq, tk, tv), ("dq", "dk", "dv")):
        _close(m, t.grad, MIRROR_REL, f"mirror {name} {case}")


# (B, Sq, q_offset, Hq, Hkv, D, causal, window), Sk = q_offset + Sq: a
# rank's block of queries under sequence parallelism (the keys of every
# position up to its last query)
OFFSET_CASES = [(2, 12, 20, 4, 2, 16, True, None),
                (1, 16, 24, 4, 1, 32, True, 8),
                (2, 13, 13, 2, 2, 16, True, None),
                (1, 9, 7, 8, 4, 64, True, 5)]


def _offset_inputs(B, Sq, off, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, off + Sq, Hkv, D)).astype(np.float32)
            for _ in range(2))
    g = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    return q, k, v, g


@pytest.mark.parametrize("case", OFFSET_CASES, ids=str)
def test_flash_attention_offset_matches_reference_gqa(case):
    """B3 with a query offset (the plain route, under autograd): the output
    against the reference's ``gqa_attention(q_offset=)`` and its gradients
    against ``jax.grad`` of it."""
    from repro.models import attention as JA
    from repro.models.transformer import BIG_WINDOW
    B, Sq, off, Hq, Hkv, D, causal, window = case
    q, k, v, g = _offset_inputs(B, Sq, off, Hq, Hkv, D, 3 * Sq + off)

    def jfn(q, k, v):
        return JA.gqa_attention(q, k, v, causal=causal,
                                window=BIG_WINDOW if window is None
                                else window, q_offset=off)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_out = jfn(jq, jk, jv)
    want = jax.grad(lambda q, k, v: jnp.sum(jfn(q, k, v) * g),
                    argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = _leaf(q), _leaf(k), _leaf(v)
    ops.reset_counts()
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                              q_offset=off)
    _close(out, want_out, ATTN_REL, f"offset forward {case}")
    (out * torch.from_numpy(g)).sum().backward()
    assert ops.COUNTS["flash_attention"].plain == 1
    for got, w, name in zip((tq.grad, tk.grad, tv.grad), want,
                            ("dq", "dk", "dv")):
        _close(got, w, ATTN_REL, f"offset {name} {case}")


@pytest.mark.parametrize("case", OFFSET_CASES, ids=str)
def test_flash_attention_offset_backward_formula(case):
    """The backward kernels' float64 mirror at a query offset (the dead
    tiles' bounds shift by it) against autograd through the plain
    version."""
    B, Sq, off, Hq, Hkv, D, causal, window = case
    q, k, v, g = _offset_inputs(B, Sq, off, Hq, Hkv, D, 5 * Sq + off)
    tq, tk, tv = _leaf(q), _leaf(k), _leaf(v)
    out = flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                q_offset=off)
    (out * torch.from_numpy(g)).sum().backward()
    got = _flash_bwd_mirror(*(a.astype(np.float64) for a in (
        q, k, v, out.detach().numpy(), g)), causal, window, q_offset=off)
    for m, t, name in zip(got, (tq, tk, tv), ("dq", "dk", "dv")):
        _close(m, t.grad, MIRROR_REL, f"offset mirror {name} {case}")


def test_no_gradient_means_serving_routes():
    """Without a gradient to take, the wrappers run as in serving (no
    autograd Function, no backward count), and a card call that would need
    a backward the kernel lacks is refused (checked here by the rule)."""
    x = torch.ones(2, 8, requires_grad=True)
    with torch.no_grad():
        assert not ops._needs_grad(x)
    assert ops._needs_grad(x) and not ops._needs_grad(x.detach(), None)
    with pytest.raises(NotImplementedError, match="A13b"):
        ops._no_backward("ssd_scan", x)
    ops._no_backward("ssd_scan", x.detach())
