"""The port's disaggregated prefill/decode engine against the reference's.

Each dense case of the reference's ``test_disagg.py``, and its MoE case,
runs three engines on the same bridged SMOKE qwen2-7b (qwen3-moe)
weights: the port's :class:`~repro_torch.serve.disagg.DisaggServeEngine`,
the port's monolithic :class:`~repro_torch.serve.engine.ServeEngine` and
the reference's ``DisaggServeEngine``.  The tolerance is none: greedy streams, and seeded
streams (a token's key folds the request's seed and its position), are
equal token for token.  Then the handoff's bookkeeping (accounting, clean
pools, backpressure, the flags' refusals), the thread discipline of the
prefiller's pool, the launcher's ``--disagg`` line and a traffic run under
the virtual clock, whose event log equals the reference's."""
import copy
import threading

import jax
import numpy as np
import pytest

from repro.configs import smoke_config as jax_smoke_config
from repro.models.api import build_model as jax_build_model
from repro.serve import DisaggServeEngine as JaxDisagg
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import traffic as JT
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import smoke_config
from repro_torch.launch import serve as launch
from repro_torch.models.api import build_model
from repro_torch.models.module import tree_leaves
from repro_torch.serve import DisaggServeEngine, ServeEngine
from repro_torch.serve import traffic as T


def _bridged(arch):
    """(reference model, its params, port model, bridged params)."""
    jmodel = jax_build_model(jax_smoke_config(arch).replace(remat="none"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(smoke_config(arch))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jmodel, jparams, model, params


@pytest.fixture(scope="module")
def dense():
    return _bridged("qwen2-7b")


@pytest.fixture(scope="module")
def moe():
    return _bridged("qwen3-moe-235b-a22b")


def _prompts(vocab):
    # two identical prompts (prefix-cache sharing), one long (chunked
    # prefill), one short: the reference's parity workload
    return [np.arange(1, 20, dtype=np.int32) % vocab,
            np.arange(1, 20, dtype=np.int32) % vocab,
            np.arange(5, 40, dtype=np.int32) % vocab,
            np.arange(2, 9, dtype=np.int32) % vocab]


def _streams(engine, prompts, max_new=8, seeded=False, close=True):
    for i, p in enumerate(prompts):
        engine.submit(p, max_new_tokens=max_new,
                      **({"seed": i} if seeded else {}))
    finished = engine.run_until_drained()
    if close:
        engine.close()
    assert len(finished) == len(prompts)
    return {r.rid: list(r.output) for r in finished}


def _three(dense, prompts, *, max_new=8, seeded=False, disagg_kw=None,
           **kw):
    """Streams of the port's disagg engine, the port's monolithic engine
    and the reference's disagg engine (serial) on the same workload; the
    port's disagg engine is returned open for further checks."""
    jmodel, jparams, model, params = dense
    disagg_kw = disagg_kw or {}
    port = DisaggServeEngine(model, params, device="cpu", **disagg_kw, **kw)
    got = _streams(port, prompts, max_new, seeded, close=False)
    mono = _streams(ServeEngine(model, params, device="cpu", **kw), prompts,
                    max_new, seeded)
    ref_kw = {k: v for k, v in disagg_kw.items() if k != "executor"}
    want = _streams(JaxDisagg(jmodel, jparams, **ref_kw, **kw), prompts,
                    max_new, seeded)
    return got, mono, want, port


KW = dict(max_slots=3, max_len=64, page_size=8, num_pages=24,
          prefill_chunk=16)
TIGHT = dict(max_slots=3, max_len=32, page_size=4, num_pages=8,
             prefill_chunk=8)
SMALL = dict(max_slots=2, max_len=32, page_size=4, num_pages=8,
             prefill_chunk=8)


def _pool_whole(eng):
    assert not eng._pending and not eng.prefiller.handoffs
    for pool in (eng.prefiller.pool, eng.decoder.pool):
        assert pool.pages_in_use == 0
        assert pool.pages_free + pool.pages_cached == pool.num_pages


@pytest.mark.parametrize("prefix_cache", [False, True])
@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_disagg_matches_monolithic_and_reference(dense, prefix_cache,
                                                 kv_quant):
    got, mono, want, port = _three(dense, _prompts(dense[2].cfg.vocab),
                                   prefix_cache=prefix_cache,
                                   kv_quant=kv_quant, **KW)
    port.close()
    assert got == mono == want


@pytest.mark.parametrize("prefix_cache", [False, True])
@pytest.mark.parametrize("kv_quant", [None, "int8"])
def test_disagg_matches_monolithic_moe(moe, prefix_cache, kv_quant):
    """The reference's MoE case: the expert block needs nothing new of the
    handoff; each role routes its own forwards and counts them."""
    got, mono, want, port = _three(moe, _prompts(moe[2].cfg.vocab),
                                   prefix_cache=prefix_cache,
                                   kv_quant=kv_quant, **KW)
    assert got == mono == want
    s = port.stats
    routed = s["prefill"]["moe_tokens_routed"] + \
        s["decode"]["moe_tokens_routed"]
    assert routed > 0 and s["prefill"]["moe_tokens_routed"] > 0
    port.close()


def test_disagg_under_forced_preemption(dense):
    """A decode pool too small for every injected request forces preemption
    on the decoder; recompute keeps the streams."""
    v = dense[2].cfg.vocab
    prompts = [np.arange(1, 8, dtype=np.int32) % v,
               np.arange(3, 12, dtype=np.int32) % v,
               np.arange(7, 13, dtype=np.int32) % v]
    got, mono, want, port = _three(dense, prompts, max_new=12,
                                   disagg_kw={"prefill_pages": 16}, **TIGHT)
    assert got == mono == want
    assert port.decoder.stats["preemptions"] > 0, \
        "the tight pool was meant to force decoder preemption"
    port.close()


def test_disagg_thread_executor(dense):
    """The two stages overlapping on farm threads never change a token."""
    got, mono, want, port = _three(dense, _prompts(dense[2].cfg.vocab),
                                   disagg_kw={"executor": "thread"}, **KW)
    _pool_whole(port)
    port.close()
    assert got == mono == want


def test_disagg_seeded_sampling(dense):
    """A seeded request's key folds (seed, len(output)), whichever engine
    draws, so sampled streams transfer too."""
    got, mono, want, port = _three(dense, _prompts(dense[2].cfg.vocab),
                                   seeded=True, **KW)
    port.close()
    assert got == mono == want


def test_disagg_instant_finish_stays_on_prefiller(dense):
    """A one-token budget finishes at the first token: the request retires
    on the prefiller and no packet is made for it."""
    jmodel, jparams, model, params = dense
    prompt = np.arange(1, 9, dtype=np.int32) % model.cfg.vocab
    eng = DisaggServeEngine(model, params, device="cpu", **KW)
    eng.submit(prompt, max_new_tokens=1)
    finished = eng.run_until_drained()
    assert len(finished) == 1 and len(finished[0].output) == 1
    assert eng.prefiller.stats["kv_handoffs"] == 0
    assert eng.decoder.stats["kv_injections"] == 0
    assert finished[0] in eng.prefiller.finished
    eng.close()
    ref = JaxDisagg(jmodel, jparams, **KW)
    ref.submit(prompt, max_new_tokens=1)
    assert [r.output for r in ref.run_until_drained()] \
        == [finished[0].output]
    ref.close()


def test_disagg_error_requests_retire_on_prefiller(dense):
    """An empty prompt errors out on the prefiller without disturbing the
    healthy request, whose stream is the reference's."""
    jmodel, jparams, model, params = dense
    prompt = np.arange(1, 9, dtype=np.int32) % model.cfg.vocab
    outs = []
    for eng in (DisaggServeEngine(model, params, device="cpu", **KW),
                JaxDisagg(jmodel, jparams, **KW)):
        ok = eng.submit(prompt, max_new_tokens=4)
        bad = eng.submit(np.asarray([], np.int32), max_new_tokens=4)
        finished = {r.rid: r for r in eng.run_until_drained()}
        assert finished[bad].error is not None and not finished[bad].output
        assert finished[ok].error is None and len(finished[ok].output) == 4
        assert finished[bad] in eng.prefiller.finished
        outs.append(finished[ok].output)
        eng.close()
    assert outs[0] == outs[1]


def test_disagg_handoff_accounting_and_clean_pools(dense):
    """Every handoff is injected exactly once, and after draining both pools
    hold no page in use (everything free or parked in the prefix cache)."""
    got, mono, want, port = _three(dense, _prompts(dense[2].cfg.vocab),
                                   **KW)
    assert got == mono == want
    assert port.prefiller.stats["kv_handoffs"] == 4
    assert port.decoder.stats["kv_injections"] == 4
    assert port.stats["pending_handoffs"] == 0
    _pool_whole(port)
    port.close()


def test_disagg_backpressure_with_tiny_prefill_pool(dense):
    """In-flight packets pin prefiller pages, so a tiny prefill pool stalls
    admission until the decoder drains, and the streams still agree."""
    v = dense[2].cfg.vocab
    prompts = [np.arange(1, 8, dtype=np.int32) % v,
               np.arange(2, 12, dtype=np.int32) % v,
               np.arange(3, 10, dtype=np.int32) % v]
    got, mono, want, port = _three(dense, prompts, max_new=6,
                                   disagg_kw={"prefill_pages": 8}, **SMALL)
    _pool_whole(port)
    port.close()
    assert got == mono == want


def test_prefill_only_flag_validation(dense):
    """The reference's three refusals, with its messages, on both."""
    jmodel, jparams, model, params = dense
    for cls, m, p, kw in ((ServeEngine, model, params, {"device": "cpu"}),
                          (JaxServeEngine, jmodel, jparams, {})):
        with pytest.raises(ValueError, match="prefill_only requires the paged"):
            cls(m, p, paged=False, prefill_only=True, **kw)
        with pytest.raises(ValueError, match="spec_decode on a prefill_only"):
            cls(m, p, prefill_only=True, spec_decode="ngram", **KW, **kw)
        eng = cls(m, p, paged=False, **kw)
        with pytest.raises(ValueError, match="requires the paged KV engine"):
            eng.inject_prefilled(None)
        eng.close()


def test_prefill_only_refuses_encoder_decoder(dense):
    """The enc-dec refusal is keyed on the model's config, as in the
    reference: a decoder-only model whose config names decoder layers is
    refused too."""
    model = copy.copy(dense[2])
    model.cfg = model.cfg.replace(decoder_layers=2)
    assert model.cfg.is_encoder_decoder
    with pytest.raises(ValueError, match=r"prefill_only on .* \(enc-dec\)"):
        ServeEngine(model, dense[3], prefill_only=True, device="cpu", **KW)


def test_prefiller_pool_is_touched_by_one_stage_at_a_time(dense):
    """Under the thread executor the prefill stage may be inside the
    prefiller's tick on one farm thread while the decode stage runs on
    another.  Every call into the prefiller's pool must come from the
    prefill stage or from between ticks, never from the decode stage: the
    pool's refcounts, cached count and free list are read-modify-writes.
    The reference releases delivered packets (a decref of the prefiller's
    pool) inside its decode stage; the same probe records that."""
    jmodel, jparams, model, params = dense

    def probe(eng):
        where = threading.local()
        calls = []
        for stage in ("_prefill_stage", "_decode_stage"):
            real = getattr(eng, stage)

            def wrapped(real=real, stage=stage):
                where.stage = stage
                try:
                    return real()
                finally:
                    where.stage = None
            setattr(eng, stage, wrapped)
        pool = eng.prefiller.pool
        for name in ("alloc", "incref", "decref", "free", "unregister"):
            real = getattr(pool, name)

            def counted(*a, real=real, name=name, **k):
                calls.append((name, getattr(where, "stage", None)))
                return real(*a, **k)
            setattr(pool, name, counted)
        return calls

    port = DisaggServeEngine(model, params, executor="thread", device="cpu",
                             **KW)
    ref = JaxDisagg(jmodel, jparams, executor="thread", **KW)
    seen = []
    for eng in (port, ref):
        calls = probe(eng)
        _streams(eng, _prompts(model.cfg.vocab))
        assert any(name == "decref" for name, _ in calls)
        seen.append({stage for _, stage in calls})
    assert "_decode_stage" not in seen[0], seen[0]
    assert "_decode_stage" in seen[1], \
        "the reference was expected to decref the prefiller's pool from " \
        "its decode stage"


@pytest.mark.parametrize("executor", ["serial", "thread"])
def test_launcher_disagg_summary(executor, capsys):
    """``--smoke --device cpu --disagg``: every request through a handoff,
    the summary line, and only plain versions on the CPU."""
    eng = launch.main(["--smoke", "--device", "cpu", "--disagg",
                       "--requests", "5", "--max-new", "5", "--max-len",
                       "64", "--shared-prefix", "8", "--executor",
                       executor])
    out = capsys.readouterr().out
    assert (f"[serve] disagg: 5 requests, 25 tokens in" in out
            and "handoffs=5 | decode ticks=" in out
            and f"injections=5 preempt=0 [executor={executor}]" in out)
    assert "rmsnorm: launches=0 plain=" in out
    assert len(eng.finished) == 5


def test_launcher_refuses_disagg_with_dense():
    with pytest.raises(SystemExit, match="--disagg needs the paged KV"):
        launch.parse_args(["--disagg", "--dense"])


def test_traffic_on_disagg_matches_reference(dense):
    """Under the virtual clock a traffic run through the port's disagg
    engine gives the reference disagg engine's event log, token streams
    and report."""
    jmodel, jparams, model, params = dense
    wl_kw = dict(kind="poisson", n_requests=8, rate=0.5, seed=3,
                 max_new_tokens=6, shared_prefix_len=8, n_sessions=2,
                 vocab=model.cfg.vocab)
    slo = {"ttft": 24.0, "e2e": 96.0}
    eng = DisaggServeEngine(model, params, device="cpu", **KW)
    got = T.run_traffic(eng, T.make_workload(**wl_kw), slo=slo)
    _pool_whole(eng)
    eng.close()
    jeng = JaxDisagg(jmodel, jparams, **KW)
    want = JT.run_traffic(jeng, JT.make_workload(**wl_kw), slo=slo)
    jeng.close()
    assert got["events"] == want["events"]
    assert got["outputs"] == want["outputs"]
    assert got["report"] == want["report"]
    assert got["report"]["n_measured"] == 8


def test_weight_quant_shares_one_quantized_tree(dense):
    """With int8 weights both roles serve the same quantized tensors, and
    the streams equal the monolithic int8 engine's."""
    _, _, model, params = dense
    eng = DisaggServeEngine(model, params, device="cpu", weight_quant="int8",
                            **KW)
    assert all(a is b for a, b in zip(tree_leaves(eng.prefiller.params),
                                      tree_leaves(eng.decoder.params)))
    got = _streams(eng, _prompts(model.cfg.vocab))
    mono = _streams(ServeEngine(model, params, device="cpu",
                                weight_quant="int8", **KW),
                    _prompts(model.cfg.vocab))
    assert got == mono


