"""The port's dense decoder against the reference's, call by call: bridged
weights, the same numpy-seeded tokens and page tables, and after each
paged prefill chunk and each paged decode step the logits and every page
storage leaf compared (qwen2-7b with QKV bias, qwen3-1.7b with QK-norm,
SMOKE configs in float32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models.api import build_model as jax_build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import smoke_config
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.api import build_model

ATOL = 1e-4          # float32 on both sides; only summation order differs
PS, N_PAGES, P = 8, 10, 6       # page size, pool pages (+1 trash), table width


def _perturbed_params(jmodel, seed):
    """Reference init plus seeded noise, so the zero-initialised biases and
    the unit norm scales are exercised too; numpy leaves."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    return jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        tree)


@pytest.fixture(scope="module", params=["qwen2-7b", "qwen3-1.7b"])
def models(request):
    jcfg = jax_smoke_config(request.param).replace(remat="none")
    jmodel = jax_build_model(jcfg)
    np_params = _perturbed_params(jmodel, seed=len(request.param))
    model = build_model(smoke_config(request.param))
    params = params_from_numpy(np_params, device="cpu")
    return jcfg, np_params, model, params


def _storage_pair(cfg):
    shape = (cfg.n_layers, N_PAGES + 1, PS, cfg.n_kv_heads, cfg.head_dim)
    jst = {"k": jnp.zeros(shape, jnp.float32),
           "v": jnp.zeros(shape, jnp.float32)}
    tst = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    return jst, tst


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL, err_msg=what)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_paged_prefill_then_decode_match_reference(models, use_pallas):
    """Two prefill chunks (the second right-padded) into one slot's pages,
    then three batched decode steps with a second, dead slot writing to the
    trash page: logits and both storage leaves match after every call."""
    jcfg, np_params, model, params = models
    jcfg = jcfg.replace(use_pallas=use_pallas)
    jmodel = jax_build_model(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    rng = np.random.default_rng(7)
    jst, tst = _storage_pair(jcfg)
    table = np.array([3, 1, 5, 0, 6, 2], np.int32)
    prompt = rng.integers(0, jcfg.vocab, 27).astype(np.int32)
    C = 2 * PS
    for start in (0, C):
        toks = np.zeros((1, C), np.int32)
        valid = min(C, len(prompt) - start)
        toks[0, :valid] = prompt[start:start + valid]
        pages = table[start // PS:(start + C) // PS]
        jst, jh, _ = jmodel.paged_prefill_chunk(
            jparams, jst, jnp.asarray(table), jnp.asarray(pages),
            np.int32(start), jnp.asarray(toks), None, use_pallas=use_pallas)
        th = model.paged_prefill_chunk(
            params, tst, torch.from_numpy(table), torch.from_numpy(pages),
            start, torch.from_numpy(toks))
        _close(model.lm_head(params, th), jmodel.lm_head(jparams, jh, None),
               f"prefill logits @ {start}")
        for leaf in ("k", "v"):
            _close(tst[leaf], jst[leaf], f"prefill {leaf} @ {start}")

    tables = np.stack([table, np.zeros_like(table)])
    tok = np.array([[int(prompt[-1])], [0]], np.int32)
    for step in range(3):
        ln = len(prompt) + step
        lengths = np.array([ln, 0], np.int32)
        wpages = np.array([table[ln // PS], N_PAGES], np.int32)
        woffs = np.array([ln % PS, 0], np.int32)
        jst, jlog, _ = jmodel.paged_decode_step(
            jparams, jst, jnp.asarray(tables), jnp.asarray(lengths),
            jnp.asarray(tok), jnp.asarray(wpages), jnp.asarray(woffs), None,
            use_pallas=use_pallas)
        tlog = model.paged_decode_step(
            params, tst, torch.from_numpy(tables), torch.from_numpy(lengths),
            torch.from_numpy(tok), torch.from_numpy(wpages),
            torch.from_numpy(woffs))
        assert tlog.dtype == torch.float32 and tlog.shape == jlog.shape
        _close(tlog[:1], jlog[:1], f"decode logits step {step}")
        for leaf in ("k", "v"):
            _close(tst[leaf], jst[leaf], f"decode {leaf} step {step}")
        tok = np.array([[int(np.argmax(np.asarray(jlog)[0, 0]))], [0]],
                       np.int32)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_paged_attention_calls_match_reference(use_pallas):
    """paged_window_attention (a prefill window after a scalar n_cached)
    and paged_decode_attention (one query per slot, ragged lengths) against
    the reference's, the port's lengths built by window_lengths."""
    rng = np.random.default_rng(12)
    Hq, Hkv, D, n_pages, n_tab = 6, 2, 16, 9, 4
    kp = rng.normal(size=(n_pages + 1, PS, Hkv, D)).astype(np.float32)
    vp = rng.normal(size=(n_pages + 1, PS, Hkv, D)).astype(np.float32)
    tables = np.stack([rng.permutation(n_pages)[:n_tab] for _ in range(3)]
                      ).astype(np.int32)
    jkv = (jnp.asarray(kp), jnp.asarray(vp))
    tkv = (torch.from_numpy(kp), torch.from_numpy(vp))

    W, start = 5, 19                   # prefill window: B = 1, scalar start
    q = rng.normal(size=(1, W, Hq, D)).astype(np.float32)
    want = JA.paged_window_attention(jnp.asarray(q), *jkv,
                                     jnp.asarray(tables[:1]), start,
                                     use_pallas=use_pallas)
    got = A.paged_window_attention(
        torch.from_numpy(q), *tkv, torch.from_numpy(tables[:1]),
        A.window_lengths(start, 1, "cpu"))
    _close(got, want, "paged_window_attention")

    q = rng.normal(size=(3, 1, Hq, D)).astype(np.float32)
    lens = np.array([n_tab * PS, 9, PS + 1], np.int32)   # incl. the current
    want = JA.paged_decode_attention(jnp.asarray(q), *jkv,
                                     jnp.asarray(tables), jnp.asarray(lens),
                                     use_pallas=use_pallas)
    got = A.paged_decode_attention(
        torch.from_numpy(q), *tkv, torch.from_numpy(tables),
        A.window_lengths(torch.from_numpy(lens) - 1, 3, "cpu"))
    _close(got, want, "paged_decode_attention")


def test_layers_match_reference():
    """linear, mlp and rope against the reference layers."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 100, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        L.rope(torch.from_numpy(x), torch.from_numpy(pos), theta=1e6).numpy(),
        np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), theta=1e6)),
        rtol=0, atol=ATOL)
    h = rng.normal(size=(2, 5, 16)).astype(np.float32)
    lin = {"w": rng.normal(size=(16, 8)).astype(np.float32),
           "b": rng.normal(size=(8,)).astype(np.float32)}
    mlp = {k: rng.normal(size=s).astype(np.float32) * 0.2
           for k, s in (("gate", (16, 32)), ("up", (16, 32)),
                        ("down", (32, 16)))}
    for tfn, jfn, p in ((L.linear, JL.linear, lin), (L.mlp, JL.mlp, mlp)):
        got = tfn({k: torch.from_numpy(v) for k, v in p.items()},
                  torch.from_numpy(h))
        want = jfn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(h))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)


def test_init_is_seeded_and_uses_config_dtype():
    model = build_model(smoke_config("qwen2-7b").replace(dtype="bfloat16"))
    a = model.init(3, device="cpu")
    b = model.init(3, device="cpu")
    assert a["blocks"]["mlp"]["gate"].dtype == torch.bfloat16
    assert torch.equal(a["blocks"]["mlp"]["gate"], b["blocks"]["mlp"]["gate"])
    assert torch.all(a["blocks"]["attn"]["bq"] == 0)
    assert torch.all(a["final_norm"]["scale"] == 1)
    ref_shapes = jax.tree.map(
        lambda p: tuple(p.shape),
        jax_build_model(jax_smoke_config("qwen2-7b")).param_defs(),
        is_leaf=lambda p: hasattr(p, "spec"))
    got_shapes = jax.tree.map(lambda t: tuple(t.shape), a)
    assert got_shapes == ref_shapes
