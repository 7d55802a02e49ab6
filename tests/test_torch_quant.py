"""The port's int8 quantization against the reference package's: the
symmetric int8 quantizer (``optim/compress.py``) code for code on the same
numpy inputs, the KV policy and its page-leaf layout, KV bytes per token
of the full-width configs, per-tensor weight quantization of bridged
SMOKE params; and the port's own exactness contract for int8 pages:
greedy streams bit-identical across the prefix cache, copy-on-write and
preemption, the scales moving with their pages and the trash page
dequantizing to zeros."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models.api import build_model as jax_build_model
from repro.optim import compress as jcompress
from repro.serve import quant as JQ
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke_config
from repro_torch.models.api import build_model
from repro_torch.models.module import tree_leaves
from repro_torch.optim import compress
from repro_torch.serve import pages as PG
from repro_torch.serve import quant as QZ
from repro_torch.serve.engine import ServeEngine

# ---------------------------------------------------------------------------
# int8_compress / int8_decompress: equal codes and scales
# ---------------------------------------------------------------------------


def _case(name):
    rng = np.random.default_rng(len(name))
    if name == "normal":
        return rng.normal(size=(6, 3, 16)).astype(np.float32)
    if name == "rows-of-magnitudes":
        g = rng.normal(size=(5, 4, 32)).astype(np.float32)
        return g * np.float32([1e-3, 1.0, 1e3, 1e20])[None, :, None]
    if name == "zeros":
        return np.zeros((2, 3, 4), np.float32)
    if name == "extremes":
        return np.float32([[1e30, -1e30, 0.5e30, 0.0],
                           [-3.4e38, 3.4e38, 1e-38, -0.0]])
    if name == "half-steps":        # round half to even at every .5 code
        return np.float32([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 63.5]])
    raise KeyError(name)


CASES = ["normal", "rows-of-magnitudes", "zeros", "extremes", "half-steps"]


@pytest.mark.parametrize("axis", [None, -1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", CASES)
def test_int8_compress_equals_reference(name, dtype, axis):
    g = _case(name)
    jg = jnp.asarray(g, getattr(jnp, dtype))
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    jq, js = jcompress.int8_compress(jg, axis=axis)
    tq, ts = compress.int8_compress(tg, axis=axis)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for out in (torch.float32, torch.bfloat16):
        jo = jcompress.int8_decompress(jq, js, axis=axis,
                                       dtype=getattr(jnp, str(out)[6:]))
        to = compress.int8_decompress(tq, ts, axis=axis, dtype=out)
        assert to.dtype == out
        np.testing.assert_array_equal(to.float().numpy(),
                                      np.asarray(jo, np.float32))


def test_int8_compress_leaves_its_input_alone():
    g = torch.from_numpy(_case("normal"))
    before = g.clone()
    q, s = compress.int8_compress(g)
    compress.int8_decompress(q, s)
    assert torch.equal(g, before)


# ---------------------------------------------------------------------------
# the KV policy and its page leaves
# ---------------------------------------------------------------------------

def test_make_kv_quant_resolution_and_errors():
    for off in (None, "off", False):
        assert QZ.make_kv_quant(off) is None
    q = QZ.make_kv_quant("int8")
    assert isinstance(q, QZ.Int8KVQuant) and q.name == "int8"
    assert q.storage_dtype == torch.int8 and q.scale_dtype == torch.float32
    assert QZ.make_kv_quant(q) is q
    with pytest.raises(ValueError, match="unknown kv_quant 'int4'"):
        QZ.make_kv_quant("int4")
    with pytest.raises(ValueError, match="lacks quantize/dequantize"):
        QZ.make_kv_quant(object())


def test_int8_kv_policy_equals_reference():
    """quantize/dequantize of one K/V block: codes and scales exactly the
    reference policy's; each row within half its own step."""
    k = np.random.default_rng(3).normal(size=(4, 16, 2, 32)).astype(
        np.float32)
    jq, js = JQ.Int8KVQuant().quantize(jnp.asarray(k))
    tq, ts = QZ.Int8KVQuant().quantize(torch.from_numpy(k))
    assert ts.shape == (4, 16, 2)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = QZ.Int8KVQuant().dequantize(tq, ts).numpy()
    assert np.all(np.abs(back - k) <= ts.numpy()[..., None] / 2 + 1e-6)


def test_quantize_leaf_specs_layout():
    leaf = PG.PagedLeafSpec((3,), (2, 16), torch.bfloat16)
    specs = QZ.quantize_leaf_specs({"k": leaf, "v": leaf},
                                   QZ.make_kv_quant("int8"))
    assert list(specs) == ["k", "k_scale", "v", "v_scale"]
    assert specs["k"] == PG.PagedLeafSpec((3,), (2, 16), torch.int8)
    assert specs["v_scale"] == PG.PagedLeafSpec((3,), (2,), torch.float32)
    assert QZ.quantize_leaf_specs({"k": leaf}, None) == {"k": leaf}
    with pytest.raises(TypeError, match="dict leaf tree"):
        QZ.quantize_leaf_specs([leaf], QZ.make_kv_quant("int8"))
    with pytest.raises(ValueError, match="no trailing axis"):
        QZ.quantize_leaf_specs({"k": PG.PagedLeafSpec((3,), (), torch.float32)},
                               QZ.make_kv_quant("int8"))


@pytest.mark.parametrize("arch,full,int8", [("qwen2-7b", 57344, 29568),
                                            ("qwen3-1.7b", 114688, 59136)])
def test_kv_bytes_per_token_full_width_equals_reference(arch, full, int8):
    """The full-width configs' leaf specs (no params needed)."""
    model = build_model(get_config(arch))
    jmodel = jax_build_model(jax_get_config(arch))
    for quant, want in ((None, full), ("int8", int8)):
        got = QZ.kv_bytes_per_token(
            model.paged_leaf_specs(QZ.make_kv_quant(quant)))
        ref = JQ.kv_bytes_per_token(
            jmodel.paged_leaf_specs(JQ.make_kv_quant(quant)))
        assert got == ref == want


# ---------------------------------------------------------------------------
# weights-only int8
# ---------------------------------------------------------------------------

def _flat(tree, is_pair, prefix=()):
    """{path: leaf} with ``{"q8", "s8"}`` pairs kept whole."""
    if isinstance(tree, dict) and not is_pair(tree):
        return {p: v for k, sub in tree.items()
                for p, v in _flat(sub, is_pair, prefix + (k,)).items()}
    return {prefix: tree}


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen3-1.7b"])
def test_quantize_params_equals_reference(arch):
    """Bridged SMOKE params: the same leaves quantized (every floating leaf
    of two or more axes of the stacked tree, so the norm scales, biases and
    both tables too; only final_norm stays float), equal codes, scales and
    dequantized values."""
    jmodel = jax_build_model(jax_smoke_config(arch).replace(remat="none"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    jq = _flat(JQ.quantize_params(jparams), JQ._is_q8)
    tq = _flat(QZ.quantize_params(params), QZ.is_q8)
    assert sorted(jq) == sorted(tq)
    floats = [p for p, v in tq.items() if not QZ.is_q8(v)]
    assert floats == [("final_norm", "scale")]
    assert ("blocks", "ln1", "scale") in tq and ("embed", "table") in tq
    for path, want in jq.items():
        got = tq[path]
        if QZ.is_q8(got):
            assert got["q8"].dtype == torch.int8 and got["s8"].ndim == 0
            np.testing.assert_array_equal(got["q8"].numpy(),
                                          np.asarray(want["q8"]))
            np.testing.assert_array_equal(got["s8"].numpy(),
                                          np.asarray(want["s8"]))
    jd = _flat(JQ.dequantize_params(JQ.quantize_params(jparams)), JQ._is_q8)
    td = _flat(QZ.dequantize_params(QZ.quantize_params(params)), QZ.is_q8)
    for path in jd:
        np.testing.assert_array_equal(td[path].numpy(), np.asarray(jd[path]))


def test_quantize_params_is_idempotent_and_init_can_quantize():
    model = build_model(smoke_config("qwen3-1.7b"))
    params = model.init(0, device="cpu")
    once = QZ.quantize_params(params)
    at_init = model.init(0, device="cpu", weight_quant="int8")
    for tree in (QZ.quantize_params(once), at_init):
        assert len(tree_leaves(tree)) == len(tree_leaves(once))
        for a, b in zip(tree_leaves(tree), tree_leaves(once)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown weight_quant"):
        model.init(0, device="cpu", weight_quant="int4")


# ---------------------------------------------------------------------------
# int8 pages in the pool, and the port's exactness contract
# ---------------------------------------------------------------------------

def test_int8_pool_zeroes_and_copies_scales_with_pages():
    """Fresh int8 storage is zero codes and zero scales, so the trash page
    dequantizes to zeros; copy-on-write copies a page's scales with its
    codes."""
    model = build_model(smoke_config("qwen2-7b"))
    specs = model.paged_leaf_specs(QZ.make_kv_quant("int8"))
    pool = PG.PagePool(specs, num_pages=4, page_size=8, device="cpu")
    st = pool.storage
    assert st["k"].dtype == torch.int8 and st["k_scale"].dtype == torch.float32
    assert st["k_scale"].shape == st["k"].shape[:-1]
    trash = pool.trash_page
    deq = QZ.Int8KVQuant().dequantize(st["k"][:, trash],
                                      st["k_scale"][:, trash])
    assert not deq.any()
    rng = np.random.default_rng(0)
    for name in ("k", "v"):
        vals = torch.from_numpy(rng.normal(size=st[name].shape[:1] + (8,) +
                                           st[name].shape[3:]).astype(
                                               np.float32))
        q, s = QZ.Int8KVQuant().quantize(vals)
        st[name][:, 1] = q
        st[name + "_scale"][:, 1] = s
    PG.copy_pages(st, specs, torch.tensor([1]), torch.tensor([3]))
    for name in st:
        assert torch.equal(st[name][:, 3], st[name][:, 1]), name
    pool.reset_storage()
    assert all(not t.any() for t in pool.storage.values())


def _conserved(eng):
    pool = eng.pool
    assert pool.pages_free + pool.pages_cached + pool.pages_in_use \
        == pool.num_pages
    assert eng.sched.held_pages() == sum(pool.ref(p)
                                         for p in range(pool.num_pages))


def _streams(model, params, prompts, *, max_new=12, **kw):
    eng = ServeEngine(model, params, page_size=16, prefill_chunk=16,
                      device="cpu", kv_quant="int8", **kw)
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    while eng.tick() or eng.sched.has_work():
        _conserved(eng)
    assert all(r.error is None for r in eng.finished)
    return {r.rid: r.output for r in eng.finished}, eng


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen3-1.7b"])
def test_int8_streams_exact_across_prefix_cache(arch):
    """Per-row scales make a shared page hold exactly the codes a fresh
    prefill writes, so int8 streams are the same with the cache on or off
    (with the cache on, the pages are shared and copied on write)."""
    model = build_model(smoke_config(arch))
    params = model.init(0, device="cpu")
    rng = np.random.default_rng(2)
    pre = rng.integers(0, model.cfg.vocab, 24)
    a = np.concatenate([pre, rng.integers(0, model.cfg.vocab, 12)])
    # pre[:20] replays a's first page and shares its second, partial, while
    # a still decodes in it: its first decode write copies that page
    prompts = [a, pre[:20], a[:30],
               np.concatenate([pre, rng.integers(0, model.cfg.vocab, 5)])]
    on, eng = _streams(model, params, prompts, max_slots=2, max_len=96,
                       prefix_cache=True)
    off, _ = _streams(model, params, prompts, max_slots=2, max_len=96,
                      prefix_cache=False)
    assert on == off
    assert eng.stats["prefix_hits"] >= 1 and eng.stats["cow_copies"] >= 1
    assert eng.stats["kv_quant"] == "int8"


def test_int8_streams_exact_under_preemption():
    """A pool of 4 pages forces preemption (recompute) with scale leaves in
    the storage; the streams equal an unstarved int8 run's."""
    model = build_model(smoke_config("qwen2-7b"))
    params = model.init(0, device="cpu")
    prompts = [[5, 17, 33, 2, 9, 1, 2, 3], [100, 200, 300, 4, 5, 6, 7, 8]]
    want, _ = _streams(model, params, prompts, max_new=30, max_slots=2,
                       max_len=64)
    got, eng = _streams(model, params, prompts, max_new=30, max_slots=2,
                        max_len=64, num_pages=4)
    assert got == want
    assert eng.stats["preemptions"] >= 1
