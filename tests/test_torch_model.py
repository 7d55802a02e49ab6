"""The port's dense decoder against the reference's, call by call: bridged
weights, the same numpy-seeded tokens and page tables, and after each
paged prefill chunk and each paged decode step the logits and every page
storage leaf compared; the dense per-slot path's whole-prompt prefill
(hidden states and cache) and ragged decode steps (logits and cache)
likewise, against the reference with ``use_pallas=False`` (qwen2-7b with
QKV bias, qwen3-1.7b with QK-norm, SMOKE configs in float32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.api import build_model as jax_build_model
from repro.serve import quant as JQ
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import smoke_config
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.api import build_model
from repro_torch.serve import quant as QZ

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
        th, _ = model.paged_prefill_chunk(
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
        tlog, _ = model.paged_decode_step(
            params, tst, torch.from_numpy(tables), torch.from_numpy(lengths),
            torch.from_numpy(tok), torch.from_numpy(wpages),
            torch.from_numpy(woffs))
        assert tlog.dtype == torch.float32 and tlog.shape == jlog.shape
        _close(tlog[:1], jlog[:1], f"decode logits step {step}")
        for leaf in ("k", "v"):
            _close(tst[leaf], jst[leaf], f"decode {leaf} step {step}")
        tok = np.array([[int(np.argmax(np.asarray(jlog)[0, 0]))], [0]],
                       np.int32)


def _int8_storage_pair(cfg):
    shape = (cfg.n_layers, N_PAGES + 1, PS, cfg.n_kv_heads, cfg.head_dim)
    jst = {"k": jnp.zeros(shape, jnp.int8), "v": jnp.zeros(shape, jnp.int8),
           "k_scale": jnp.zeros(shape[:-1], jnp.float32),
           "v_scale": jnp.zeros(shape[:-1], jnp.float32)}
    tst = {k: torch.zeros(v.shape, dtype=getattr(torch, str(v.dtype)))
           for k, v in jst.items()}
    return jst, tst


# K/V computed in another summation order can land on the other side of an
# int8 rounding boundary: the share of codes one step apart is limited
# (measured on the CPU: at most 1.8e-4, one V code of 5632, in one call;
# 0 in the others), and a flipped code moves the later logits by up to
# 4.2e-4, so int8 logits get a wider limit than ATOL
CODE_FLIP_LIMIT = 1e-3
INT8_ATOL = 1e-3


def _close_int8_storage(tst, jst, what):
    """Scales allclose at rtol 1e-5, codes within one step everywhere and
    rarely apart at all."""
    for leaf in ("k_scale", "v_scale"):
        np.testing.assert_allclose(tst[leaf].numpy(), np.asarray(jst[leaf]),
                                   rtol=1e-5, atol=0, err_msg=f"{what} {leaf}")
    for leaf in ("k", "v"):
        d = np.abs(tst[leaf].numpy().astype(np.int32)
                   - np.asarray(jst[leaf]).astype(np.int32))
        assert d.max() <= 1, f"{what} {leaf}: codes {d.max()} apart"
        share = float((d > 0).mean())
        assert share <= CODE_FLIP_LIMIT, f"{what} {leaf}: {share} differ"


@pytest.mark.parametrize("weights", ["float", "int8"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_paged_int8_calls_match_reference(models, use_pallas, weights):
    """int8 KV pages (and int8 weights): two prefill chunks and three decode
    steps with a dead slot, as in the float test above, against the
    reference with its int8 policy; the reference's weights dequantized as
    its engine does, the port's passed quantized."""
    jcfg, np_params, model, params = models
    jcfg = jcfg.replace(use_pallas=use_pallas)
    jmodel = jax_build_model(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    if weights == "int8":
        jparams = JQ.dequantize_params(JQ.quantize_params(jparams))
        params = QZ.quantize_params(params)
    jq, tq = JQ.make_kv_quant("int8"), QZ.make_kv_quant("int8")
    rng = np.random.default_rng(8)
    jst, tst = _int8_storage_pair(jcfg)
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
            np.int32(start), jnp.asarray(toks), None, use_pallas=use_pallas,
            quant=jq)
        th, _ = model.paged_prefill_chunk(
            params, tst, torch.from_numpy(table), torch.from_numpy(pages),
            start, torch.from_numpy(toks), quant=tq)
        np.testing.assert_allclose(
            model.lm_head(params, th).numpy(),
            np.asarray(jmodel.lm_head(jparams, jh, None)), rtol=0,
            atol=INT8_ATOL, err_msg=f"prefill logits @ {start}")
        _close_int8_storage(tst, jst, f"prefill @ {start}")

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
            use_pallas=use_pallas, quant=jq)
        tlog, _ = model.paged_decode_step(
            params, tst, torch.from_numpy(tables), torch.from_numpy(lengths),
            torch.from_numpy(tok), torch.from_numpy(wpages),
            torch.from_numpy(woffs), quant=tq)
        assert tlog.dtype == torch.float32 and tlog.shape == jlog.shape
        np.testing.assert_allclose(tlog[:1].numpy(), np.asarray(jlog)[:1],
                                   rtol=0, atol=INT8_ATOL,
                                   err_msg=f"decode logits step {step}")
        _close_int8_storage(tst, jst, f"decode step {step}")
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


# (B, Sq, Sk, Hq, Hkv, kwargs): numpy arrays in kwargs become (B,) inputs
GQA_CASES = {
    "causal": (2, 24, 24, 6, 2, dict()),
    "window": (1, 40, 40, 4, 2, dict(window=9)),
    "bidirectional-mqa": (2, 16, 16, 4, 1, dict(causal=False)),
    "ragged-decode": (3, 1, 32, 6, 2,
                      dict(q_offset=np.array([0, 13, 31], np.int32),
                           kv_valid_len=np.array([1, 14, 32], np.int32),
                           kv_chunk=32)),
    "ragged-window": (3, 2, 32, 6, 2,
                      dict(q_offset=np.array([3, 17, 30], np.int32),
                           kv_valid_len=np.array([5, 19, 32], np.int32),
                           window=6, kv_chunk=32)),
    "chunked-kv": (2, 3, 64, 4, 2,
                   dict(q_offset=40, kv_valid_len=43, kv_chunk=16)),
    "chunked-prefill": (1, 64, 64, 4, 2, dict(kv_chunk=16, q_offset=0,
                                              kv_valid_len=64)),
    "ring-k-start": (2, 1, 8, 4, 2, dict(window=8, q_offset=20,
                                         k_start=13, kv_chunk=8)),
}


@pytest.mark.parametrize("case", list(GQA_CASES))
def test_gqa_attention_matches_reference(case):
    """The plain online-softmax path (and, for whole sequences, the
    flash route) against the reference's jnp path."""
    B, Sq, Sk, Hq, Hkv, kw = GQA_CASES[case]
    rng = np.random.default_rng(len(case))
    D = 16
    q = rng.normal(size=(B, Sq, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32)
    jkw = {n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()}
    tkw = {n: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()}
    want = JA.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            **jkw)
    got = A.gqa_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), **tkw)
    _close(got, want, case)


def _dense_pair(models):
    jcfg, np_params, model, params = models
    return (jax_build_model(jcfg.replace(use_pallas=False)),
            jax.tree.map(jnp.asarray, np_params), model, params)


def test_dense_prefill_then_ragged_decode_match_reference(models):
    """Whole-prompt prefill of two right-padded prompts (hidden states and
    the cache padded to max_len), then three decode steps with the two
    slots at different lengths, writing into the cache in place: logits
    and both cache leaves match after every call."""
    jmodel, jparams, model, params = _dense_pair(models)
    cfg = model.cfg
    rng = np.random.default_rng(13)
    S, max_len = 24, 40
    toks = rng.integers(0, cfg.vocab, (2, S)).astype(np.int32)
    lens = np.array([17, 24], np.int32)
    toks[0, lens[0]:] = 0                           # right-padding
    jcache, jh = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                None, max_len)
    cache, h = model.prefill(params, torch.from_numpy(toks), max_len)
    _close(h, jh, "prefill hidden")
    for leaf in ("k", "v"):
        _close(cache[leaf], jcache[leaf], f"prefill cache {leaf}")

    pos = lens.copy()
    tok = np.array([[3], [7]], np.int32)
    for step in range(3):
        jcache, jlog = jmodel.decode_step(jparams, jcache, jnp.asarray(tok),
                                          jnp.asarray(pos), None)
        tlog = model.decode_step(params, cache, torch.from_numpy(tok),
                                 torch.from_numpy(pos))
        assert tlog.dtype == torch.float32 and tlog.shape == jlog.shape
        _close(tlog, jlog, f"decode logits step {step}")
        for leaf in ("k", "v"):
            _close(cache[leaf], jcache[leaf], f"decode {leaf} step {step}")
        tok = np.argmax(np.asarray(jlog)[:, 0], -1)[:, None].astype(np.int32)
        pos = pos + 1


def test_dense_path_routes_only_prefill_to_flash(models):
    """Whole-prompt prefill runs flash attention once a layer; decode
    (Sq == 1, masked by kv_valid_len) never does, not even at Sk == 1."""
    from repro_torch.kernels import ops
    _, _, model, params = models
    n = model.cfg.n_layers
    ops.reset_counts()
    cache, _ = model.prefill(params, torch.tensor([[5, 6, 7]]), 8)
    assert ops.COUNTS["flash_attention"].plain == n
    model.decode_step(params, cache, torch.tensor([[1]]), torch.tensor([3]))
    one = model.init_decode_state(1, 1, device="cpu")
    model.decode_step(params, one, torch.tensor([[1]]), 0)
    assert ops.COUNTS["flash_attention"].plain == n
    assert T.layer_windows(model.cfg) == [None] * n
    ops.reset_counts()


def test_window_caches_wait_for_their_slice(models):
    _, _, model, _ = models
    gemma_like = model.cfg.replace(local_window=4, global_every=2)
    with pytest.raises(NotImplementedError, match="A11"):
        T.init_cache(gemma_like, 1, 8, dtype=torch.float32, device="cpu")


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
