"""The port's serving engine on the MoE decoders against the reference's
engine, on bridged SMOKE weights (float32, CPU): greedy token streams
equal token for token, and the five MoE stats (``moe_tokens_routed``,
``moe_dropped_tokens``, ``expert_tokens``, ``expert_imbalance``,
``placement_updates``) equal exactly.  Paged with the prefix cache on and
off, chunked prefill under forced preemption, arctic (experts beside a
dense MLP), int8 KV pages and int8 weights, speculative decode (ngram and
the self-1 drafter), capacity-factor drops with expert placement every 2
ticks, and the dense per-slot path (``paged=False``, no telemetry); then
the launcher's ``[serve] moe:`` line."""
import re

import jax
import numpy as np
import pytest

from repro.configs import smoke_config as jax_smoke_config
from repro.models.api import build_model as jax_build_model
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import smoke_config
from repro_torch.launch import serve as launch
from repro_torch.models.api import build_model
from repro_torch.serve.engine import ServeEngine

MOE_STATS = ("moe_tokens_routed", "moe_dropped_tokens", "expert_tokens",
             "expert_imbalance", "placement_updates")
SHARED = list(range(1, 25))
WAVES = [[SHARED], [SHARED, SHARED[:20] + [77, 78]], [list(range(50, 71))],
         [SHARED]]
PROMPTS = [[5, 17, 33, 5, 17, 33, 5, 17], [7] * 11,
           [1, 2, 3, 4, 1, 2, 3, 4, 1, 2], [9, 9, 8, 8, 9, 9, 8, 8]]
PREEMPT_PROMPTS = [[5, 17, 33, 2, 9, 1, 2, 3], [100, 200, 300, 4, 5, 6, 7, 8]]


def _pair(arch, **cfg_kw):
    jmodel = jax_build_model(
        jax_smoke_config(arch).replace(remat="none", **cfg_kw))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(smoke_config(arch).replace(**cfg_kw))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jmodel, jparams, model, params


@pytest.fixture(scope="module")
def qwen():
    return _pair("qwen3-moe-235b-a22b")


def _serve(engine_cls, model, params, waves, *, max_new=8, **kw):
    kw.setdefault("prefill_chunk", 16)
    eng = engine_cls(model, params, page_size=16, **kw)
    for wave in waves:
        for p in wave:
            eng.submit(p, max_new_tokens=max_new)
        eng.run_until_drained()
    eng.close()
    assert all(r.error is None for r in eng.finished)
    return {r.rid: r.output for r in eng.finished}, eng


def _both(pair, waves, **kw):
    """(port streams, reference streams, port engine, reference engine)."""
    jmodel, jparams, model, params = pair
    want, jeng = _serve(JaxServeEngine, jmodel, jparams, waves, **kw)
    got, eng = _serve(ServeEngine, model, params, waves, device="cpu", **kw)
    return got, want, eng, jeng


def _same_moe_stats(eng, jeng, routed=True):
    s, js = eng.stats, jeng.stats
    for k in MOE_STATS:
        assert s[k] == js[k], k
    assert s["moe_tokens_routed"] == sum(s["expert_tokens"])
    if routed:
        assert s["moe_tokens_routed"] > 0


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_streams_and_telemetry_match_reference(qwen, prefix_cache):
    """Waves sharing a 24-token prefix (a full-prompt replay included): with
    the cache on, the hits skip chunks, and the routed counts follow."""
    got, want, eng, jeng = _both(qwen, WAVES, max_slots=2, max_len=128,
                                 prefix_cache=prefix_cache)
    assert got == want
    _same_moe_stats(eng, jeng)
    for k in ("ticks", "chunk_prefills", "prefix_hits"):
        assert eng.stats[k] == jeng.stats[k], k
    assert (eng.stats["prefix_hits"] > 0) == prefix_cache


def test_streams_match_reference_under_forced_preemption(qwen):
    """A pool at the single-request minimum forces preemption; the
    recomputed chunks are routed again and counted."""
    got, want, eng, jeng = _both(qwen, [PREEMPT_PROMPTS], max_new=30,
                                 max_slots=2, max_len=64, num_pages=4)
    assert got == want
    assert eng.stats["preemptions"] >= 1
    _same_moe_stats(eng, jeng)


def test_arctic_streams_match_reference():
    """arctic: top-2 experts beside the dense residual MLP in every
    block."""
    got, want, eng, jeng = _both(_pair("arctic-480b"), WAVES[:2],
                                 max_slots=3, max_len=128)
    assert got == want
    _same_moe_stats(eng, jeng)


def test_int8_kv_and_weights_match_reference(qwen):
    """int8 KV pages, then int8 KV pages and int8 weights (the expert
    stacks' codes with one scale each): the reference's int8 streams."""
    for kw in ({"kv_quant": "int8"},
               {"kv_quant": "int8", "weight_quant": "int8"}):
        got, want, eng, jeng = _both(qwen, WAVES[:2], max_slots=2,
                                     max_len=128, **kw)
        assert got == want, kw
        _same_moe_stats(eng, jeng)


@pytest.mark.parametrize("drafter", ["ngram", "self-1"])
def test_spec_decode_matches_reference(qwen, drafter):
    """Verify windows route every window position (pad included): the
    streams equal the reference's spec-on streams and the spec-off ones,
    and the telemetry is the reference's."""
    kw = dict(max_slots=3, max_len=128, max_new=12)
    got, want, eng, jeng = _both(qwen, [PROMPTS], spec_decode=drafter, **kw)
    off, _, _, _ = _both(qwen, [PROMPTS], **kw)
    assert got == want == off
    assert eng.stats["draft_proposed"] > 0
    for k in ("draft_proposed", "draft_accepted"):
        assert eng.stats[k] == jeng.stats[k], k
    _same_moe_stats(eng, jeng)


def test_drops_and_placement_match_reference():
    """capacity_factor 0.5 drops assignments; re-placing the experts every
    2 ticks leaves the streams and the telemetry as they were, and both
    equal the reference's."""
    pair = _pair("qwen3-moe-235b-a22b", capacity_factor=0.5)
    kw = dict(max_slots=4, max_len=96, prefill_chunk=32, max_new=6)
    prompts = [[[5, 17, 33, 2, 9], [7] * 9, [1, 2, 3] * 4,
                [100, 200, 300, 4, 5, 6, 7]]]
    got, want, eng, jeng = _both(pair, prompts, **kw)
    assert got == want
    assert eng.stats["moe_dropped_tokens"] > 0
    _same_moe_stats(eng, jeng)
    placed, jwant, peng, jpeng = _both(pair, prompts, placement_interval=2,
                                       **kw)
    assert placed == jwant == got
    assert peng.stats["placement_updates"] >= 1
    _same_moe_stats(peng, jpeng)
    assert sorted(peng.placement.phys_expert.tolist()) == list(range(8))
    for k in ("moe_tokens_routed", "moe_dropped_tokens", "expert_tokens"):
        assert peng.stats[k] == eng.stats[k], k


def test_update_placement_needs_a_paged_moe_engine(qwen):
    dense = build_model(smoke_config("qwen2-7b"))
    eng = ServeEngine(dense, dense.init(0, device="cpu"), max_slots=2,
                      max_len=32, page_size=16, device="cpu")
    with pytest.raises(ValueError, match="expert placement"):
        eng.update_placement()
    assert eng.stats["moe_tokens_routed"] == 0
    assert eng.stats["expert_tokens"] == []
    _, _, model, params = qwen
    deng = ServeEngine(model, params, max_slots=2, max_len=32, paged=False,
                       device="cpu")
    with pytest.raises(ValueError, match="expert placement"):
        deng.update_placement()
    deng.close()


def test_dense_path_matches_reference(qwen):
    """``paged=False``: whole-prompt prefills and per-slot decode through
    the serial block; no telemetry, as in the reference."""
    jmodel, jparams, model, params = qwen
    kw = dict(max_slots=3, max_len=64, paged=False)
    want, jeng = _serve(JaxServeEngine, jmodel, jparams, [PROMPTS[:3]], **kw)
    got, eng = _serve(ServeEngine, model, params, [PROMPTS[:3]],
                      device="cpu", **kw)
    assert got == want
    _same_moe_stats(eng, jeng, routed=False)


def test_launcher_moe_line(capsys):
    """The launcher serves qwen3-moe SMOKE with placement every 2 ticks
    and prints the ``[serve] moe:`` line from the engine's stats."""
    eng = launch.main(["--arch", "qwen3-moe-235b-a22b", "--smoke",
                       "--device", "cpu", "--requests", "4", "--max-new",
                       "6", "--expert-placement", "2"])
    out = capsys.readouterr().out
    m = re.search(r"\[serve\] moe: routed=(\d+) dropped=(\d+) "
                  r"rank_imbalance=([\d.]+) placements=(\d+)", out)
    assert m, out
    s = eng.stats
    assert (int(m[1]), int(m[2]), int(m[4])) == (
        s["moe_tokens_routed"], s["moe_dropped_tokens"],
        s["placement_updates"])
    assert s["moe_tokens_routed"] == sum(s["expert_tokens"]) > 0
    assert s["placement_updates"] >= 1 and m[3] == "1.00"
