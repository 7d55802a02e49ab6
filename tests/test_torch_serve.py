"""The port's serving engine against the reference's: greedy token
streams on bridged weights (paged: prefix cache on and off, forced
preemption, a shared-prefix set; dense per-slot: waves of prompts in two
length buckets), page conservation, error isolation and recovery on both
paths, the prefill farm's lifecycle, and the device and feature guards of
the entry points."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models.api import build_model as jax_build_model
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import smoke_config
from repro_torch.models.api import build_model
from repro_torch.serve import pages as PG
from repro_torch.serve.engine import ServeEngine

PROMPTS = [[5, 17, 33, 2, 9], [100, 200, 300], [7] * 11]
PREEMPT_PROMPTS = [[5, 17, 33, 2, 9, 1, 2, 3], [100, 200, 300, 4, 5, 6, 7, 8]]
SHARED = list(range(1, 25))
WAVES = [[SHARED], [SHARED, SHARED[:20] + [77, 78]], [list(range(50, 71))],
         [SHARED]]


@pytest.fixture(scope="module", params=["qwen2-7b", "qwen3-1.7b"])
def pair(request):
    """(reference model, its params, port model, bridged params)."""
    jmodel = jax_build_model(
        jax_smoke_config(request.param).replace(remat="none"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(smoke_config(request.param))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jmodel, jparams, model, params


def _conserved(eng):
    pool = eng.pool
    assert pool.pages_free + pool.pages_cached + pool.pages_in_use \
        == pool.num_pages
    refs = sum(pool.ref(p) for p in range(pool.num_pages))
    assert eng.sched.held_pages() == refs


def _serve(engine_cls, model, params, waves, *, max_new=6, check=None, **kw):
    eng = engine_cls(model, params, page_size=16, prefill_chunk=16, **kw)
    for wave in waves:
        for p in wave:
            eng.submit(p, max_new_tokens=max_new)
        while eng.tick() or eng.sched.has_work():
            if check is not None:
                check(eng)
    assert all(r.error is None for r in eng.finished)
    return {r.rid: r.output for r in eng.finished}, dict(eng.stats)


def _both(pair, waves, **kw):
    jmodel, jparams, model, params = pair
    want, s_want = _serve(JaxServeEngine, jmodel, jparams, waves, **kw)
    got, s_got = _serve(ServeEngine, model, params, waves, device="cpu",
                        check=_conserved, **kw)
    return got, want, s_got, s_want


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_streams_match_reference(pair, prefix_cache):
    got, want, s_got, s_want = _both(pair, [PROMPTS], max_slots=3,
                                     max_len=128, prefix_cache=prefix_cache)
    assert got == want
    for k in ("ticks", "chunk_prefills", "prefix_hits", "pages_high_water"):
        assert s_got[k] == s_want[k], k


def test_streams_match_reference_under_forced_preemption(pair):
    """A pool at the single-request minimum (4 pages of 16 for max_len 64)
    forces preemption; recompute keeps the streams equal to the reference."""
    got, want, s_got, _ = _both(pair, [PREEMPT_PROMPTS], max_new=30,
                                max_slots=2, max_len=64, num_pages=4)
    assert got == want
    assert s_got["preemptions"] >= 1


def test_streams_match_reference_on_shared_prefix(pair):
    """Waves sharing a 24-token prefix (full-prompt replay included) hit the
    radix cache, and the streams still equal the reference's."""
    got, want, s_got, s_want = _both(pair, WAVES, max_new=12, max_slots=2,
                                     max_len=128, prefix_cache=True)
    assert got == want
    assert s_got["prefix_hits"] > 0
    assert s_got["prefix_hits"] == s_want["prefix_hits"]
    assert s_got["cow_copies"] == s_want["cow_copies"]


def test_failed_prefill_returns_its_pages(pair, monkeypatch):
    """A request whose prefill raises is retired with ``.error`` set and its
    pages go back to the pool; the other requests finish unharmed."""
    _, _, model, params = pair
    real = model.paged_prefill_chunk

    def flaky(params, storage, table_row, pages_chunk, start, tokens):
        if bool((tokens == 999).any()):
            raise ValueError("injected prefill failure")
        return real(params, storage, table_row, pages_chunk, start, tokens)

    want, _ = _serve(ServeEngine, model, params, [PROMPTS], max_slots=3,
                     max_len=128, device="cpu")
    monkeypatch.setattr(model, "paged_prefill_chunk", flaky)
    eng = ServeEngine(model, params, max_slots=3, max_len=128, page_size=16,
                      prefill_chunk=16, device="cpu")
    rids = [eng.submit(p, max_new_tokens=6) for p in PROMPTS[:2]]
    bad = eng.submit([1, 2, 999, 4] * 5, max_new_tokens=6)
    rids.append(eng.submit(PROMPTS[2], max_new_tokens=6))
    eng.run_until_drained()
    _conserved(eng)
    assert eng.pool.pages_in_use == 0
    by_rid = {r.rid: r for r in eng.finished}
    assert isinstance(by_rid[bad].error, ValueError)
    assert [by_rid[r].output for r in rids] == [want[i] for i in range(3)]


def test_failed_decode_raises_after_recovery(pair, monkeypatch):
    """A decode step that raises evicts every resident and rebuilds zeroed
    storage before the error propagates; the residents then resume by
    recompute and their greedy streams are unchanged."""
    _, _, model, params = pair
    want, _ = _serve(ServeEngine, model, params, [PROMPTS], max_slots=3,
                     max_len=128, device="cpu")
    real = model.paged_decode_step
    calls = []

    def flaky(*args):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("injected decode failure")
        return real(*args)

    monkeypatch.setattr(model, "paged_decode_step", flaky)
    eng = ServeEngine(model, params, max_slots=3, max_len=128, page_size=16,
                      prefill_chunk=16, device="cpu")
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=6)
    with pytest.raises(RuntimeError, match="injected decode failure"):
        eng.run_until_drained()
    assert eng.sched.live_slots() == [] and len(eng.sched.queue) == 3
    assert all(not t.any() for t in eng.pool.storage.values())
    eng.run_until_drained()
    _conserved(eng)
    assert {r.rid: r.output for r in eng.finished} == want


def test_page_ops_write_in_place():
    storage = torch.zeros(5, 4, 2, 3)
    rng = np.random.default_rng(0)
    chunk = torch.from_numpy(rng.normal(size=(8, 2, 3)).astype(np.float32))
    view = storage[:]
    PG.scatter_chunk(view, torch.tensor([3, 1]), chunk, page_size=4)
    tok = torch.from_numpy(rng.normal(size=(1, 2, 3)).astype(np.float32))
    PG.scatter_token(view, torch.tensor([1]), torch.tensor([2]), tok)
    got = PG.gather_pages(storage, torch.tensor([[3, 1]]))
    want = chunk.clone()
    want[4 + 2] = tok[0]
    torch.testing.assert_close(got[0], want, rtol=0, atol=0)
    spec = {"k": PG.PagedLeafSpec((), (2, 3), torch.float32)}
    PG.copy_pages({"k": storage}, spec, torch.tensor([3, 3]),
                  torch.tensor([0, 2]))
    assert torch.equal(storage[0], storage[3])
    assert torch.equal(storage[2], storage[3])
    with pytest.raises(TypeError, match="storage dtype"):
        PG.scatter_token(storage, torch.tensor([1]), torch.tensor([0]),
                         tok.double())


def test_entry_points_need_a_card_unless_told_cpu(pair):
    _, _, model, params = pair
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)
    with pytest.raises(ValueError, match="params lie on"):
        ServeEngine(model, params, device="meta")


# each unported feature alone and beside a ported one (the sampler and the
# drafter, ported since), which must not let it through
@pytest.mark.parametrize("kw", [dict(mesh=object(), sampler=lambda k, l: 0),
                                dict(prefill_only=True, spec_decode="ngram"),
                                dict(mesh=object()),
                                dict(prefill_only=True)])
def test_unported_engine_features_raise(pair, kw):
    _, _, model, params = pair
    with pytest.raises(NotImplementedError, match="not ported yet"):
        ServeEngine(model, params, device="cpu", **kw)


@pytest.mark.parametrize("kw", [
    dict(encoder_input=np.zeros((2, 64)), seed=1),
    dict(encoder_input=np.zeros((2, 64)), sampler=lambda k, l: 0),
    dict(encoder_input=np.zeros((2, 64)))])
def test_unported_request_features_raise(pair, kw):
    _, _, model, params = pair
    eng = ServeEngine(model, params, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        eng.submit([1, 2, 3], **kw)


# ---------------------------------------------------------------------------
# int8 KV pages and int8 weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefix_cache", [True, False])
def test_int8_streams_match_reference(pair, prefix_cache):
    """kv_quant="int8": the port's greedy streams equal the reference's
    int8 streams, over a shared-prefix set (prefix hits and a full-prompt
    replay with the cache on)."""
    got, want, s_got, s_want = _both(pair, WAVES, max_new=12, max_slots=2,
                                     max_len=128, prefix_cache=prefix_cache,
                                     kv_quant="int8")
    assert got == want
    for k in ("ticks", "chunk_prefills", "prefix_hits", "cow_copies",
              "pages_high_water", "kv_quant", "kv_bytes_per_token"):
        assert s_got[k] == s_want[k], k
    assert s_got["kv_quant"] == "int8"


def test_int8_streams_match_reference_under_forced_preemption(pair):
    got, want, s_got, _ = _both(pair, [PREEMPT_PROMPTS], max_new=30,
                                max_slots=2, max_len=64, num_pages=4,
                                kv_quant="int8")
    assert got == want
    assert s_got["preemptions"] >= 1


def test_int8_weight_streams_match_reference(pair):
    """weight_quant="int8" with kv_quant="int8": the port's per-layer
    dequantization gives the reference's whole-tree streams."""
    got, want, s_got, s_want = _both(pair, [PROMPTS], max_slots=3,
                                     max_len=128, kv_quant="int8",
                                     weight_quant="int8")
    assert got == want
    assert s_got["weight_quant"] == s_want["weight_quant"] == "int8"


def test_quant_flags_validated(pair):
    _, _, model, params = pair
    with pytest.raises(ValueError, match="kv_quant='int8' requires the paged"):
        ServeEngine(model, params, device="cpu", paged=False, kv_quant="int8")
    with pytest.raises(ValueError, match="unknown kv_quant"):
        ServeEngine(model, params, device="cpu", kv_quant="fp4")
    with pytest.raises(ValueError, match="paged serving path only"):
        ServeEngine(model, params, device="cpu", paged=False,
                    weight_quant="int8")
    with pytest.raises(ValueError, match="unknown weight_quant"):
        ServeEngine(model, params, device="cpu", weight_quant="int4")
    eng = ServeEngine(model, params, device="cpu", kv_quant="off",
                      weight_quant="off")
    assert (eng.stats["kv_quant"], eng.stats["weight_quant"]) == ("off", "off")
    assert eng.pool.storage["k"].dtype == torch.float32


def test_launcher_serves_int8_on_cpu(capsys):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch_serve
    eng = launch_serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                             "--max-new", "4", "--kv-quant", "int8",
                             "--weight-quant", "int8"])
    out = capsys.readouterr().out
    assert "quant(kv=int8, w=int8, 160 KV B/tok)" in out
    assert "kv_bytes_per_token=160" in out
    assert len(eng.finished) == 3
    assert all(len(r.output) == 4 for r in eng.finished)
    assert ops.COUNTS["paged_attention_mq_int8"].plain > 0
    assert ops.COUNTS["paged_attention_mq"].plain == 0


# ---------------------------------------------------------------------------
# dense per-slot path
# ---------------------------------------------------------------------------

# prompts of 3-11 tokens run at bucket 32, of 40-45 at bucket 64
DENSE_WAVES = [[[5, 17, 33, 2, 9], list(range(1, 41)), [100, 200, 300]],
               [[7] * 11, list(range(60, 105))],
               [list(range(3, 45)), [9, 8, 7, 6]]]


def _serve_dense(engine_cls, model, params, waves, *, max_new=6, **kw):
    eng = engine_cls(model, params, max_slots=3, max_len=96, paged=False,
                     **kw)
    for wave in waves:
        for p in wave:
            eng.submit(p, max_new_tokens=max_new)
        eng.run_until_drained()
    assert all(r.error is None for r in eng.finished)
    return {r.rid: r.output for r in eng.finished}, dict(eng.stats), eng


@pytest.mark.parametrize("prefill_workers", [1, 3])
def test_dense_streams_match_reference(pair, prefill_workers):
    """Three waves over two buckets, three slots: the port's dense streams
    and tick counts equal the reference's dense engine's."""
    jmodel, jparams, model, params = pair
    want, s_want, _ = _serve_dense(JaxServeEngine, jmodel, jparams,
                                   DENSE_WAVES, prefill_workers=2)
    got, s_got, eng = _serve_dense(ServeEngine, model, params, DENSE_WAVES,
                                   device="cpu",
                                   prefill_workers=prefill_workers)
    assert got == want
    for k in ("ticks", "tokens", "prefills"):
        assert s_got[k] == s_want[k], k
    assert eng.pool is None and not eng.prefix_cache
    eng.close()


def test_dense_streams_match_paged_streams(pair):
    """The port's two paths agree with each other on the same requests."""
    _, _, model, params = pair
    dense, _, eng = _serve_dense(ServeEngine, model, params, DENSE_WAVES,
                                 device="cpu")
    eng.close()
    paged = ServeEngine(model, params, max_slots=3, max_len=96,
                        page_size=16, prefill_chunk=16, device="cpu")
    for wave in DENSE_WAVES:
        for p in wave:
            paged.submit(p, max_new_tokens=6)
        paged.run_until_drained()
    assert {r.rid: r.output for r in paged.finished} == dense


def test_dense_write_slot_zeroes_the_tail(pair):
    """After a long request retires and a short one takes its slot, the
    state equals the reference's (the zero-pad past the bucket)."""
    jmodel, jparams, model, params = pair
    waves = [[list(range(1, 41))], [[5, 17, 33]]]
    eng = ServeEngine(model, params, max_slots=1, max_len=96, paged=False,
                      device="cpu")
    jeng = JaxServeEngine(jmodel, jparams, max_slots=1, max_len=96,
                          paged=False)
    for wave in waves:
        for e in (eng, jeng):
            for p in wave:
                e.submit(p, max_new_tokens=3)
            e.run_until_drained()
    for leaf in ("k", "v"):
        np.testing.assert_allclose(eng.state[leaf].numpy(),
                                   np.asarray(jeng.state[leaf]), rtol=0,
                                   atol=1e-4)
    eng.close()


def test_dense_failed_prefill_is_isolated(pair, monkeypatch):
    """A prefill that raises on a farm worker retires only its request
    (with ``.error``); the requests prefilled beside it finish unharmed."""
    _, _, model, params = pair
    want, _, eng = _serve_dense(ServeEngine, model, params, [PROMPTS],
                                device="cpu")
    eng.close()
    real = model.prefill

    def flaky(params, tokens, max_len=None):
        if bool((tokens == 999).any()):
            raise ValueError("injected prefill failure")
        return real(params, tokens, max_len)

    monkeypatch.setattr(model, "prefill", flaky)
    eng = ServeEngine(model, params, max_slots=3, max_len=96, paged=False,
                      device="cpu")
    rids = [eng.submit(p, max_new_tokens=6) for p in PROMPTS[:2]]
    bad = eng.submit([1, 2, 999, 4], max_new_tokens=6)
    rids.append(eng.submit(PROMPTS[2], max_new_tokens=6))
    eng.run_until_drained()
    by_rid = {r.rid: r for r in eng.finished}
    assert isinstance(by_rid[bad].error, ValueError)
    assert not by_rid[bad].output
    assert [by_rid[r].output for r in rids] == [want[i] for i in range(3)]
    eng.close()


def test_dense_failed_decode_evicts_and_rebuilds(pair, monkeypatch):
    """A decode step that raises evicts every resident and rebuilds a
    zeroed state before the error propagates; the residents then resume
    by recompute and their greedy streams are unchanged."""
    _, _, model, params = pair
    want, _, eng = _serve_dense(ServeEngine, model, params, [PROMPTS],
                                device="cpu")
    eng.close()
    real = model.decode_step
    calls = []

    def flaky(*args):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("injected decode failure")
        return real(*args)

    monkeypatch.setattr(model, "decode_step", flaky)
    eng = ServeEngine(model, params, max_slots=3, max_len=96, paged=False,
                      device="cpu")
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=6)
    with pytest.raises(RuntimeError, match="injected decode failure"):
        eng.run_until_drained()
    assert eng.sched.live_slots() == [] and len(eng.sched.queue) == 3
    assert all(not t.any() for t in eng.state.values())
    eng.run_until_drained()
    assert {r.rid: r.output for r in eng.finished} == want
    eng.close()


def test_close_releases_the_farm_and_the_engine_still_serves(pair):
    _, _, model, params = pair
    with ServeEngine(model, params, max_slots=2, max_len=96, paged=False,
                     device="cpu", prefill_workers=2) as eng:
        eng.submit(PROMPTS[0], max_new_tokens=3)
        eng.submit(PROMPTS[1], max_new_tokens=3)
        eng.run_until_drained()
        assert eng._prefill_farm._pool is not None
    assert eng._prefill_farm._pool is None          # __exit__ closed it
    eng.submit(PROMPTS[2], max_new_tokens=3)        # pool made anew
    eng.run_until_drained()
    assert len(eng.finished) == 3 and all(len(r.output) == 3
                                          for r in eng.finished)
    eng.close()
    assert eng._prefill_farm._pool is None


# ---------------------------------------------------------------------------
# strict and chunks_per_tick (the reference's options)
# ---------------------------------------------------------------------------

def _strict_run(engine, queue, request_cls):
    """The reference's strict-mode script: two good prompts around a bad one
    (200 tokens >= max_len 128) put straight on the queue.  Returns (error
    rids after the raising drain, streams after the second drain)."""
    engine.submit([5, 17, 33], max_new_tokens=4)
    queue.append(request_cls(1000, np.arange(200, dtype=np.int32), 4))
    engine.submit([7, 8, 9], max_new_tokens=4)
    with pytest.raises(RuntimeError,
                       match=r"prefill failed for request\(s\) \[1000\]"):
        engine.run_until_drained()
    failed = [r.rid for r in engine.finished if r.error is not None]
    done = engine.run_until_drained()
    assert sorted(r.rid for r in done if r.error is None) == [0, 1]
    return failed, {r.rid: r.output for r in done if r.error is None}


@pytest.mark.parametrize("paged", [True, False])
def test_engine_strict_raises_on_bad_request(pair, paged):
    """``strict=True`` (tests/test_serve.py's script, on the paged and the
    dense path): the tick retires the bad request with its error, commits
    the healthy work and raises; a second drain completes the rest.  The
    error rids and the streams equal the reference engine's."""
    from repro.serve.engine import Request as JaxRequest
    from repro_torch.serve.engine import Request
    jmodel, jparams, model, params = pair
    jeng = JaxServeEngine(jmodel, jparams, max_slots=3, max_len=128,
                          paged=paged, strict=True)
    want = _strict_run(jeng, jeng.queue, JaxRequest)
    jeng.close()
    with ServeEngine(model, params, max_slots=3, max_len=128, paged=paged,
                     strict=True, device="cpu") as eng:
        got = _strict_run(eng, eng.sched.queue, Request)
    assert got == want
    assert got[0] == [1000]
    if paged:
        assert eng.pool.pages_in_use == 0


def _chunked_run(engine):
    """The reference's anti-stall script at ``chunks_per_tick=1``: a short
    request goes live, then a 99-token prompt prefills in chunks of 16.
    Returns the short request's tokens added by each of six ticks, and the
    streams by prompt length after draining."""
    engine.submit([9, 8, 7], max_new_tokens=24)
    engine.run_until_drained(max_ticks=2)          # the short request is live
    short = engine.sched.slot_req[0]
    engine.submit(list(range(1, 100)), max_new_tokens=4)   # 7 chunks
    per_tick = []
    for _ in range(6):
        n = len(short.output)
        engine.tick()
        per_tick.append(len(short.output) - n)
    long_req = engine.sched.slot_req[1]
    assert long_req is not None and not long_req.output   # still prefilling
    done = engine.run_until_drained()
    assert engine.stats["chunk_prefills"] >= 7
    return per_tick, {len(r.prompt): r.output for r in done}


def test_chunked_prefill_keeps_decode_flowing(pair):
    """One prefill chunk a tick (``chunks_per_tick=1``): the live request
    emits one token every tick while the long prompt prefills, and the
    token counts per tick and the streams equal the reference's."""
    jmodel, jparams, model, params = pair
    kw = dict(max_slots=2, max_len=128, paged=True, page_size=16,
              prefill_chunk=16, chunks_per_tick=1)
    jeng = JaxServeEngine(jmodel, jparams, **kw)
    want = _chunked_run(jeng)
    jeng.close()
    got = _chunked_run(ServeEngine(model, params, device="cpu", **kw))
    assert got == want
    assert got[0] == [1] * 6
    assert len(got[1][3]) == 24 and len(got[1][99]) == 4
