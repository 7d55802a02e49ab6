"""The port's speculative decode against the reference's: the drafters'
proposals, ``scatter_window`` on float and int8 pages, the verify forward
(``paged_verify_chunk``) call by call (logits and every storage leaf), the
cache-free ``forward``, and the engine's speculative streams — greedy
streams with speculation on equal to those with it off and to the
reference's (prefix cache on and off, under forced preemption, int8
pages, the self-drafter), seeded rejection-sampled streams equal to the
reference's, extras that never preempt, the dense path's fallback, the
refusals, and a drafter's kernel failure that propagates.  SMOKE qwen2-7b
in float32 on bridged weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models import transformer as JT
from repro.models.api import build_model as jax_build_model
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import pages as JPG
from repro.serve import quant as JQ
from repro.serve import spec as JSP
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.build import KernelError
from repro_torch.models.api import build_model
from repro_torch.serve import pages as PG
from repro_torch.serve import quant as QZ
from repro_torch.serve import spec as SP
from repro_torch.serve.engine import ServeEngine

ATOL = 1e-4          # float32 on both sides; only summation order differs
INT8_ATOL = 1e-3     # a code one step apart moves later logits (model tests)
PS, N_PAGES = 8, 10

PROMPTS = ([5, 17, 33, 5, 17, 33, 5, 17], [7] * 11,
           [1, 2, 3, 4, 1, 2, 3, 4, 1, 2], [9, 9, 8, 8, 9, 9, 8, 8])


@pytest.fixture(scope="module")
def pair():
    """(reference model, its params, port model, bridged params)."""
    jmodel = jax_build_model(
        jax_smoke_config("qwen2-7b").replace(remat="none"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(smoke_config("qwen2-7b"))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jmodel, jparams, model, params


# ---------------------------------------------------------------------------
# drafters
# ---------------------------------------------------------------------------

def test_ngram_proposals_match_reference():
    """Random short-alphabet streams (repeats and loops), every n-gram
    range and window."""
    rng = np.random.default_rng(0)
    for i in range(200):
        toks = rng.integers(0, 4 if i % 2 else 12,
                            int(rng.integers(1, 40))).astype(np.int32)
        max_n = int(rng.integers(1, 5))
        min_n = int(rng.integers(1, max_n + 1))
        k = int(rng.integers(0, 6))
        np.testing.assert_array_equal(
            SP.NgramDrafter(max_n, min_n).propose(toks, k),
            JSP.NgramDrafter(max_n, min_n).propose(toks, k))


def test_self_drafter_proposals_match_reference(pair):
    """The 1-layer self-drafter's greedy rollouts, streams of several
    length buckets (16, 32, 64)."""
    jmodel, jparams, model, params = pair
    want = JSP.TruncatedSelfDrafter(jmodel, jparams, layers=1)
    got = SP.TruncatedSelfDrafter(model, params, layers=1)
    rng = np.random.default_rng(1)
    for n in (3, 16, 17, 40):
        toks = rng.integers(0, model.cfg.vocab, n).astype(np.int32)
        np.testing.assert_array_equal(got.propose(toks, 4),
                                      want.propose(toks, 4))
    assert got.layers == 1


def test_make_drafter_parses_names(pair):
    _, _, model, params = pair
    assert SP.make_drafter("ngram").max_n == 3
    assert SP.make_drafter("ngram-5").max_n == 5
    assert SP.make_drafter("self", model, params).layers == 2
    assert SP.make_drafter("self-9", model, params).layers \
        == model.cfg.n_layers                                   # clamped
    with pytest.raises(ValueError, match="model= and params="):
        SP.make_drafter("self-1")
    with pytest.raises(ValueError, match="unknown drafter"):
        SP.make_drafter("oracle")
    rwkv = build_model(smoke_config("rwkv6-3b"))
    with pytest.raises(ValueError, match="ngram drafter"):
        SP.TruncatedSelfDrafter(rwkv, {})


# ---------------------------------------------------------------------------
# device ops and model calls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pages", ["bfloat16", "int8"])
def test_scatter_window_matches_reference(pages):
    """Per-slot windows at (page, offset) pairs, pad and dead positions on
    the trash page (the last), into bf16 pages and int8 pages with their
    scale leaf, in place."""
    rng = np.random.default_rng(2)
    wpages = np.array([[0, 0, 1], [2, 3, 4], [4, 4, 4]], np.int32)
    woffs = np.array([[2, 3, 0], [3, 0, 2], [0, 0, 0]], np.int32)
    vals = rng.normal(size=(3, 3, 2, 16)).astype(np.float32)
    if pages == "int8":
        codes, scales = QZ.Int8KVQuant().quantize(torch.from_numpy(vals))
        jcodes, jscales = JQ.make_kv_quant("int8").quantize(jnp.asarray(vals))
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
        leaves = [(codes, jcodes, torch.int8), (scales, jscales,
                                                torch.float32)]
    else:
        v = torch.from_numpy(vals).to(torch.bfloat16)
        leaves = [(v, jnp.asarray(vals, jnp.bfloat16), torch.bfloat16)]
    for val, jval, dtype in leaves:
        storage = torch.zeros((5, 4) + tuple(val.shape[2:]), dtype=dtype)
        view = storage[:]
        PG.scatter_window(view, torch.from_numpy(wpages),
                          torch.from_numpy(woffs), val)
        want = JPG.scatter_window(jnp.zeros(storage.shape, jval.dtype),
                                  jnp.asarray(wpages), jnp.asarray(woffs),
                                  jval)
        # the trash page (4) takes several writes in either order
        np.testing.assert_array_equal(storage[:4].float().numpy(),
                                      np.asarray(want[:4], np.float32))


def _prefilled(jmodel, jparams, model, params, prompt, table, quant):
    """Both storages after one prefill chunk of ``prompt`` into ``table``."""
    cfg = model.cfg
    shape = (cfg.n_layers, N_PAGES + 1, PS, cfg.n_kv_heads, cfg.head_dim)
    if quant:
        jst = {"k": jnp.zeros(shape, jnp.int8), "v": jnp.zeros(shape, jnp.int8),
               "k_scale": jnp.zeros(shape[:-1], jnp.float32),
               "v_scale": jnp.zeros(shape[:-1], jnp.float32)}
    else:
        jst = {"k": jnp.zeros(shape, jnp.float32),
               "v": jnp.zeros(shape, jnp.float32)}
    tst = {k: torch.zeros(v.shape, dtype=getattr(torch, str(v.dtype)))
           for k, v in jst.items()}
    C = 2 * PS
    toks = np.zeros((1, C), np.int32)
    toks[0, :len(prompt)] = prompt
    pages = table[:C // PS]
    jq = JQ.make_kv_quant("int8") if quant else None
    tq = QZ.make_kv_quant("int8") if quant else None
    jst, _, _ = jmodel.paged_prefill_chunk(
        jparams, jst, jnp.asarray(table), jnp.asarray(pages), np.int32(0),
        jnp.asarray(toks), None, quant=jq)
    model.paged_prefill_chunk(params, tst, torch.from_numpy(table),
                              torch.from_numpy(pages), 0,
                              torch.from_numpy(toks), quant=tq)
    return jst, tst, jq, tq


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("C", [3, 5])
def test_paged_verify_chunk_matches_reference(pair, quant, C):
    """One verify window (B 3: a full window, a shorter one padded onto the
    trash page, a dead slot) after a prefill, crossing a page edge: the
    window's logits and every storage leaf against the reference's."""
    jmodel, jparams, model, params = pair
    rng = np.random.default_rng(C + quant)
    table = np.array([3, 1, 5, 0, 6, 2], np.int32)
    prompt = rng.integers(0, model.cfg.vocab, 14).astype(np.int32)
    jst, tst, jq, tq = _prefilled(jmodel, jparams, model, params, prompt,
                                  table, quant)
    tables = np.stack([table, table[::-1].copy(),
                       np.full_like(table, N_PAGES)])
    lengths = np.array([14, 5, 0], np.int32)
    toks = rng.integers(0, model.cfg.vocab, (3, C)).astype(np.int32)
    wpages = np.full((3, C), N_PAGES, np.int32)
    woffs = np.zeros((3, C), np.int32)
    for b, n in ((0, C), (1, 2)):              # slot 1: one draft of C - 1
        for i in range(n):
            pos = lengths[b] + i
            wpages[b, i] = tables[b, pos // PS]
            woffs[b, i] = pos % PS
    args = (tables, lengths, toks, wpages, woffs)
    jst, jlog, _ = jmodel.paged_verify(
        jparams, jst, *map(jnp.asarray, args), None, quant=jq)
    ops.reset_counts()
    tlog = model.paged_verify(params, tst, *map(torch.from_numpy, args),
                              quant=tq)
    L = model.cfg.n_layers          # one paged-attention call a layer
    name = "paged_attention_mq_int8" if quant else "paged_attention_mq"
    assert ops.COUNTS[name] == ops.LaunchCount(plain=L)
    assert tlog.dtype == torch.float32 and tlog.shape == jlog.shape
    atol = INT8_ATOL if quant else ATOL
    np.testing.assert_allclose(tlog[0].numpy(), np.asarray(jlog)[0], rtol=0,
                               atol=atol)
    np.testing.assert_allclose(tlog[1, :2].numpy(), np.asarray(jlog)[1, :2],
                               rtol=0, atol=atol)
    for leaf in tst:                          # the trash page aside
        got, want = tst[leaf][:, :N_PAGES], np.asarray(jst[leaf])[:, :N_PAGES]
        if leaf in ("k", "v") and quant:
            d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
            assert d.max() <= 1, leaf                 # one code step apart
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=ATOL, err_msg=leaf)


def test_forward_matches_reference(pair):
    jmodel, jparams, model, params = pair
    rng = np.random.default_rng(4)
    toks = rng.integers(0, model.cfg.vocab, (2, 32)).astype(np.int32)
    want, _ = JT.forward(jparams, jmodel.cfg, None, tokens=jnp.asarray(toks))
    got = model.forward(params, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _streams(engine_cls, model, params, *, n_req=4, max_new=12, seeds=(),
             **kw):
    eng = engine_cls(model, params, max_slots=3, max_len=128,
                     prefill_chunk=16, **kw)
    for i, p in enumerate(PROMPTS[:n_req]):
        eng.submit(p, max_new_tokens=max_new,
                   seed=i if i in seeds else None)
    done = eng.run_until_drained()
    eng.close()
    assert all(r.error is None for r in done)
    return {r.rid: [int(t) for t in r.output] for r in done}, eng


def _conserved(eng):
    pool = eng.pool
    assert pool.pages_free + pool.pages_cached == pool.num_pages
    assert eng.sched.held_pages() == 0


@pytest.mark.parametrize("kw", [dict(prefix_cache=False),
                                dict(prefix_cache=True),
                                dict(kv_quant="int8"),
                                dict(drafter="self-1")],
                         ids=["cache-off", "cache-on", "int8", "self-1"])
def test_spec_greedy_streams_match_spec_off_and_reference(pair, kw):
    """Speculation changes the ticks, never a token: the port's spec-on
    streams equal its spec-off streams and the reference's spec-on
    streams, with the same acceptance counters."""
    jmodel, jparams, model, params = pair
    kw = dict(kw)
    drafter = kw.pop("drafter", "ngram")
    off, eng_off = _streams(ServeEngine, model, params, device="cpu", **kw)
    want, jeng = _streams(JaxServeEngine, jmodel, jparams,
                          spec_decode=drafter, **kw)
    got, eng = _streams(ServeEngine, model, params, device="cpu",
                        spec_decode=drafter, **kw)
    assert got == off == want
    s = eng.stats
    assert s["draft_proposed"] > 0
    for k in ("draft_proposed", "draft_accepted", "acceptance_rate",
              "ticks"):
        assert s[k] == jeng.stats[k], k
    assert s["ticks"] < eng_off.stats["ticks"]
    widths = s["verify_widths"]     # spec_k 4: half and full windows
    assert widths and set(widths) <= {3, 5}
    assert sum(widths.values()) <= s["ticks"]
    assert eng_off.stats["verify_widths"] == {}
    _conserved(eng)


def test_spec_parity_under_forced_preemption(pair):
    """A pool at the single-request minimum forces preemption; recompute
    plus verify rollback keep the streams equal to spec-off and the
    reference's, and the pool conserved."""
    jmodel, jparams, model, params = pair

    def tight(engine_cls, m, p, **kw):
        eng = engine_cls(m, p, max_slots=2, max_len=64, paged=True,
                         page_size=16, num_pages=4, prefill_chunk=16, **kw)
        eng.submit([5, 17, 33, 2, 9, 1, 2, 3], max_new_tokens=30)
        eng.submit([100, 200, 300, 4, 5, 6, 7, 8], max_new_tokens=30)
        done = eng.run_until_drained()
        eng.close()
        assert all(r.error is None for r in done)
        return {r.rid: [int(t) for t in r.output] for r in done}, eng

    off, eng_off = tight(ServeEngine, model, params, device="cpu")
    assert eng_off.stats["preemptions"] >= 1
    want, _ = tight(JaxServeEngine, jmodel, jparams, spec_decode="ngram")
    got, eng = tight(ServeEngine, model, params, device="cpu",
                     spec_decode="ngram")
    assert got == off == want
    _conserved(eng)


def test_spec_sampled_streams_match_reference_and_reproduce(pair):
    """spec_temperature > 0 with seeded and unseeded requests: the
    rejection-sampled streams equal the reference's and reproduce."""
    jmodel, jparams, model, params = pair
    kw = dict(spec_decode="ngram", spec_temperature=1.0, seeds=(0, 2))
    want, _ = _streams(JaxServeEngine, jmodel, jparams, **kw)
    got, eng = _streams(ServeEngine, model, params, device="cpu", **kw)
    again, _ = _streams(ServeEngine, model, params, device="cpu", **kw)
    assert got == want == again
    off, _ = _streams(ServeEngine, model, params, device="cpu")
    assert got != off                                 # actually sampling


def test_spec_windows_never_preempt_for_extras(pair):
    """A pool where plain decode just fits behaves the same with
    speculation on: verify windows are best-effort."""
    _, _, model, params = pair

    def run(spec):
        eng = ServeEngine(model, params, max_slots=2, max_len=32, paged=True,
                          page_size=4, num_pages=16, prefill_chunk=8,
                          prefix_cache=False, spec_decode=spec, device="cpu")
        eng.submit([5, 17, 33, 5, 17, 33, 5], max_new_tokens=20)
        eng.submit([7, 7, 7, 7, 7, 7, 7], max_new_tokens=20)
        done = eng.run_until_drained()
        assert all(r.error is None for r in done)
        return {r.rid: r.output for r in done}, eng.stats["preemptions"]

    want, pre_off = run(None)
    got, pre_on = run("ngram")
    assert got == want
    assert pre_on == pre_off == 0


def test_spec_falls_back_on_the_dense_path(pair):
    _, _, model, params = pair
    want, _ = _streams(ServeEngine, model, params, device="cpu", paged=False)
    got, eng = _streams(ServeEngine, model, params, device="cpu",
                        paged=False, spec_decode="ngram")
    assert eng.drafter is None and got == want
    assert eng.stats["draft_proposed"] == 0


def test_spec_refusals(pair):
    _, _, model, params = pair
    with pytest.raises(ValueError, match="default greedy"):
        ServeEngine(model, params, device="cpu", spec_decode="ngram",
                    sampler=lambda k, lg: torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="self-K drafter"):
        ServeEngine(model, params, device="cpu", spec_decode="self-1",
                    weight_quant="int8")
    eng = ServeEngine(model, params, device="cpu", spec_decode="ngram",
                      spec_temperature=0.7)
    assert eng.drafter is not None


class _Raising:
    """A drafter whose proposal raises ``err``."""

    def __init__(self, err):
        self.err = err

    def propose(self, tokens, k):
        raise self.err


def test_drafter_failure_costs_nothing_but_a_kernel_failure_raises(pair):
    """A drafter that raises means no drafts (the streams are the plain
    ones); one whose kernel fails raises out of the tick, with this tick's
    prefill failures retired first."""
    _, _, model, params = pair
    want, _ = _streams(ServeEngine, model, params, device="cpu")
    got, eng = _streams(ServeEngine, model, params, device="cpu",
                        spec_decode=_Raising(ValueError("sloppy")))
    assert got == want and eng.stats["draft_proposed"] == 0
    eng = ServeEngine(model, params, max_slots=3, max_len=128,
                      prefill_chunk=16, device="cpu",
                      spec_decode=_Raising(KernelError("launch failed")))
    eng.submit(PROMPTS[0], max_new_tokens=4)
    bad = eng.submit([], max_new_tokens=4)             # retired at admission
    with pytest.raises(KernelError, match="launch failed"):
        eng.run_until_drained()
    assert [r.rid for r in eng.finished] == [bad]
    assert isinstance(eng.finished[0].error, ValueError)


@pytest.mark.parametrize("err", [ValueError("refused"), TypeError("refused"),
                                 RuntimeError("refused")],
                         ids=["ValueError", "TypeError", "RuntimeError"])
def test_self_drafter_failure_reaches_the_caller(pair, monkeypatch, err):
    """The port's own self-drafter runs its kernels' wrappers, which refuse
    input with ValueError or TypeError (an asynchronous CUDA fault surfaces
    as RuntimeError): any of them raises out of the tick and is never read
    as "no drafts"."""
    _, _, model, params = pair
    eng = ServeEngine(model, params, max_slots=3, max_len=128,
                      prefill_chunk=16, device="cpu", spec_decode="self-1")

    def refuse(toks, n_valid):
        raise err

    monkeypatch.setattr(eng.drafter, "_next_logits", refuse)
    eng.submit(PROMPTS[0], max_new_tokens=4)
    with pytest.raises(type(err), match="refused"):
        eng.run_until_drained()
    assert eng.stats["draft_proposed"] == 0
