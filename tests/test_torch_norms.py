"""RMSNorm's fused variants in the port (``add_rmsnorm``: the residual add
and the norm; ``gated_rmsnorm``: Mamba-2's SiLU gate and the norm) against
the reference package, on the same numpy-seeded inputs, and the counts
that show the models fold every residual add into the norm after it.

Tolerances: the norm of ``s`` at ``test_torch_kernels.py``'s rmsnorm
limits (float32 1e-5: summation order; bf16 2e-2: one rounding of an O(1)
output); the sum ``s`` itself bit for bit (one rounding of the same float32
sum in both frameworks).  The gated norm in float32 at 1e-5; with bf16 z
at 2e-2, since the reference's ``jax.nn.silu`` rounds inside bf16 where the
port's ``F.silu`` rounds its float32 result once, which moves the gate by
up to about one bf16 ulp before the norm.  The CUDA kernels against these
plain versions on a card are in ``test_torch_gpu.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels import rmsnorm as jrn
from repro.models import layers as JL
from repro_torch.configs import smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.models.api import build_model

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# ragged row counts, and a d that is no multiple of the kernel's vector (8)
SHAPES = [(4, 64), (3, 37, 100), (257, 72), (1, 1001)]


def _pair(a: np.ndarray, dtype: str):
    """One numpy array as (jax array, torch tensor) of the same values."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_rmsnorm_plain_matches_reference(shape, dtype):
    rng = np.random.default_rng(11)
    xj, xt = _pair(rng.normal(size=shape).astype(np.float32), dtype)
    dj, dt = _pair(rng.normal(size=shape).astype(np.float32), dtype)
    sj, st = _pair(rng.normal(size=shape[-1:]).astype(np.float32), "float32")
    s, y = ref.add_rmsnorm(xt, dt, st)
    assert s.dtype == y.dtype == xt.dtype
    want_s = xj + dj
    np.testing.assert_array_equal(_np(s), _np(want_s))
    tol = TOL[dtype]
    for want in (jref.rmsnorm(want_s, sj),
                 jrn.rmsnorm(want_s, sj, interpret=True)):
        np.testing.assert_allclose(_np(y), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("z_dtype", ["float32", "bfloat16"])
def test_gated_rmsnorm_plain_matches_reference(shape, z_dtype):
    """y float32 and z as Mamba-2 holds them (bf16 at full width, float32
    on SMOKE)."""
    rng = np.random.default_rng(12)
    y = rng.normal(size=shape).astype(np.float32)
    zj, zt = _pair((2 * rng.normal(size=shape)).astype(np.float32), z_dtype)
    sj, st = _pair(rng.normal(size=shape[-1:]).astype(np.float32), z_dtype)
    got = ref.gated_rmsnorm(torch.from_numpy(y), zt, st)
    assert got.dtype == zt.dtype and got.shape == zt.shape
    want = JL.rmsnorm({"scale": sj},
                      jnp.asarray(y).astype(zj.dtype) * jax.nn.silu(zj))
    tol = TOL[z_dtype]
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def test_fused_wrappers_count_under_rmsnorm_on_the_plain_route():
    rng = np.random.default_rng(13)
    x, d, y = (torch.from_numpy(rng.normal(size=(3, 16)).astype(np.float32))
               for _ in range(3))
    ops.reset_counts()
    s, h = ops.add_rmsnorm(x, d, torch.ones(16))
    g = ops.gated_rmsnorm(y, x, torch.ones(16))
    assert torch.equal(s, x + d)
    torch.testing.assert_close(h, ref.rmsnorm(x + d, torch.ones(16)))
    torch.testing.assert_close(
        g, ref.rmsnorm(y * torch.nn.functional.silu(x), torch.ones(16)))
    counts = {k: (c.kernel, c.plain) for k, c in ops.COUNTS.items()
              if c.kernel or c.plain}
    assert counts == {"rmsnorm": (0, 2), "rmsnorm_add": (0, 1),
                      "rmsnorm_gated": (0, 1)}
    ops.reset_counts()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_add_rmsnorm_without_the_sum(dtype):
    """keep_sum=False, as the models' final norm calls it: the same norm,
    no sum, counted as a fused add."""
    rng = np.random.default_rng(14)
    _, x = _pair(rng.normal(size=(5, 37)).astype(np.float32), dtype)
    _, d = _pair(rng.normal(size=(5, 37)).astype(np.float32), dtype)
    scale = torch.from_numpy(rng.normal(size=37).astype(np.float32))
    ops.reset_counts()
    s, y = ops.add_rmsnorm(x, d, scale, keep_sum=False)
    assert s is None
    assert torch.equal(y, ref.add_rmsnorm(x, d, scale)[1])
    assert (ops.COUNTS["rmsnorm_add"].plain,
            ops.COUNTS["rmsnorm"].plain) == (1, 1)
    ops.reset_counts()


def _norm_counts():
    c = ops.COUNTS
    return (c["rmsnorm"].plain - c["rmsnorm_add"].plain
            - c["rmsnorm_gated"].plain, c["rmsnorm_add"].plain,
            c["rmsnorm_gated"].plain)


def test_transformer_steps_fold_every_residual_add_into_a_norm():
    """One SMOKE paged decode step, one paged prefill chunk and one dense
    prefill each run 1 standalone RMSNorm (the first block's ln1) and 2 L
    fused add + norm calls (every other ln1, every ln2, the final norm)."""
    model = build_model(smoke_config("qwen2-7b"))
    cfg = model.cfg
    params = model.init(0, device="cpu")
    L, ps = cfg.n_layers, 8
    shape = (L, 5, ps, cfg.n_kv_heads, cfg.head_dim)
    storage = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    tables = torch.tensor([[0, 1], [4, 4]], dtype=torch.int32)
    ops.reset_counts()
    model.paged_decode_step(params, storage, tables,
                            torch.tensor([3, 0], dtype=torch.int32),
                            torch.tensor([[5], [0]]),
                            torch.tensor([0, 4], dtype=torch.int32),
                            torch.tensor([3, 0], dtype=torch.int32))
    assert _norm_counts() == (1, 2 * L, 0)
    ops.reset_counts()
    model.paged_prefill_chunk(params, storage, tables[0], tables[0], 0,
                              torch.arange(2 * ps)[None] % cfg.vocab)
    assert _norm_counts() == (1, 2 * L, 0)
    ops.reset_counts()
    model.prefill(params, torch.tensor([[5, 6, 7]]), 8)
    assert _norm_counts() == (1, 2 * L, 0)
    ops.reset_counts()


def test_zamba_step_folds_every_residual_add_into_a_norm():
    """One SMOKE zamba2 decode step (6 Mamba layers in 2 segments): 1
    standalone RMSNorm, n_layers + 2 segments fused adds (every Mamba
    layer's norm but the first, each shared block's two, the final norm)
    and n_layers gated norms; at full width 1, 87 and 81."""
    model = build_model(smoke_config("zamba2-7b"))
    cfg = model.cfg
    params = model.init(0, device="cpu")
    segments = cfg.n_layers // cfg.shared_attn_every
    assert (cfg.n_layers, segments) == (6, 2)
    state, _ = model.prefill(params, torch.tensor([[5, 6, 7], [1, 2, 3]]), 8)
    ops.reset_counts()
    model.decode_step(params, state, torch.tensor([[4], [9]]), 3)
    assert _norm_counts() == (1, cfg.n_layers + 2 * segments, cfg.n_layers)
    ops.reset_counts()
