"""The port's traffic harness and metric report against the reference's:
seeded workloads (greedy, seeded and multimodal bands), the report's
arithmetic on a synthetic event log, and whole harness runs under the
virtual clock (event log, token streams and report) on the paged and
dense paths, greedy and seeded-sampled, plus trace replay and the
launcher's ``--traffic`` report."""
import functools
import json
import sys

import jax
import numpy as np
import pytest

from repro.configs import smoke_config as jax_smoke_config
from repro.launch import serve as jax_launch
from repro.models.api import build_model as jax_build_model
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import metrics as JM
from repro.serve import sampling as JS
from repro.serve import traffic as JT
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import smoke_config
from repro_torch.launch import serve as launch
from repro_torch.models.api import build_model
from repro_torch.serve import metrics as M
from repro_torch.serve import sampling as S
from repro_torch.serve import traffic as T
from repro_torch.serve.engine import ServeEngine

ENGINE_KW = dict(max_slots=3, max_len=64, page_size=8, num_pages=24,
                 prefill_chunk=16)
WL_KW = dict(n_requests=8, rate=0.5, seed=3, max_new_tokens=6,
             shared_prefix_len=8, n_sessions=2)
SLO = {"ttft": 24.0, "e2e": 96.0}


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


def _same_requests(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.arrival == w.arrival
        assert np.array_equal(g.prompt, w.prompt)
        assert g.prompt.dtype == w.prompt.dtype
        assert (g.max_new_tokens, g.session, g.seed) \
            == (w.max_new_tokens, w.session, w.seed)
        if w.encoder_input is None:
            assert g.encoder_input is None
        else:
            assert np.array_equal(g.encoder_input, w.encoder_input)


@pytest.mark.parametrize("kw", [dict(kind="poisson"), dict(kind="bursty"),
                                dict(kind="poisson", seeded_sampling=True),
                                dict(kind="bursty", encoder="image",
                                     encoder_shape=(4, 16))])
def test_workloads_match_reference(kw):
    """The same arguments give the reference's request schedule."""
    _same_requests(T.make_workload(vocab=491, **WL_KW, **kw),
                   JT.make_workload(vocab=491, **WL_KW, **kw))


def test_report_matches_reference_on_a_synthetic_log():
    """compute_report over a random event log with an errored and an
    unfinished request, with and without an SLO; and the percentiles."""
    rng = np.random.default_rng(0)
    events = []
    for rid in range(12):
        t = float(rng.uniform(0, 20))
        events.append({"t": t, "rid": rid, "kind": "submit"})
        for _ in range(int(rng.integers(1, 6))):
            t += float(rng.exponential(2.0))
            events.append({"t": t, "rid": rid, "kind": "tokens",
                           "n": int(rng.integers(1, 3))})
        if rid != 11:
            events.append({"t": t + 0.5, "rid": rid, "kind": "done",
                           "error": rid == 4})
    for slo in (None, {"ttft": 5.0, "e2e": 12.0, "itl": 3.0}):
        assert M.compute_report(events, slo=slo) \
            == JM.compute_report(events, slo=slo)
    xs = list(rng.normal(size=37))
    for q in (0, 1, 50, 95, 99, 100):
        assert M.nearest_rank(xs, q) == JM.nearest_rank(xs, q)
    assert M.percentiles(xs) == JM.percentiles(xs)
    assert M.nearest_rank([], 50) is None


def _run(engine_cls, model, params, workload, **ekw):
    eng = engine_cls(model, params, **{**ENGINE_KW, **ekw})
    res = (JT if engine_cls is JaxServeEngine else T).run_traffic(
        eng, workload, slo=SLO)
    eng.close()
    return res


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("seeded", [False, True])
def test_harness_matches_reference(pair, paged, seeded):
    """Under the virtual clock the port's engine gives the reference's event
    log, token streams and report: greedy, and seeded requests under an
    engine-wide temperature sampler."""
    jmodel, jparams, model, params = pair
    v = model.cfg.vocab
    jkw, kw = {}, {}
    if seeded:
        jkw["sampler"] = functools.partial(JS.sample_temperature,
                                           temperature=0.9, true_vocab=v)
        kw["sampler"] = functools.partial(S.sample_temperature,
                                          temperature=0.9, true_vocab=v)
    wl = T.make_workload(kind="poisson", vocab=v, seeded_sampling=seeded,
                         **WL_KW)
    jwl = JT.make_workload(kind="poisson", vocab=v, seeded_sampling=seeded,
                           **WL_KW)
    want = _run(JaxServeEngine, jmodel, jparams, jwl, paged=paged, **jkw)
    got = _run(ServeEngine, model, params, wl, paged=paged, device="cpu",
               **kw)
    assert got["events"] == want["events"]
    assert got["outputs"] == want["outputs"]
    assert got["report"] == want["report"]
    assert got["report"]["n_measured"] == WL_KW["n_requests"]


def test_trace_replay_round_trip(pair):
    """Record a run, rebuild the workload from its JSON trace, replay on a
    fresh engine: identical token streams and event log."""
    _, _, model, params = pair
    wl = T.make_workload(kind="bursty", vocab=model.cfg.vocab, **WL_KW)
    first = _run(ServeEngine, model, params, wl, device="cpu")
    trace = json.loads(json.dumps(T.record_trace(wl, first["events"],
                                                 first["outputs"])))
    replayed = T.workload_from_trace(trace)
    _same_requests(replayed, wl)
    second = _run(ServeEngine, model, params, replayed, device="cpu")
    assert second["events"] == trace["events"]
    assert {str(k): v for k, v in second["outputs"].items()} \
        == trace["outputs"]


def test_encoder_workload_is_refused(pair):
    _, _, model, params = pair
    wl = T.make_workload(kind="poisson", vocab=model.cfg.vocab,
                         encoder="image", encoder_shape=(4, 16), **WL_KW)
    eng = ServeEngine(model, params, device="cpu", **ENGINE_KW)
    with pytest.raises(NotImplementedError, match="A10"):
        T.run_traffic(eng, wl)


def test_launcher_traffic_report_matches_reference(tmp_path, monkeypatch,
                                                   capsys):
    """``--traffic poisson --clock virtual --metrics-out``: the report the
    port's launcher writes is the reference launcher's."""
    argv = ["--arch", "qwen2-7b", "--smoke", "--requests", "5", "--max-new",
            "5", "--max-len", "64", "--shared-prefix", "8", "--traffic",
            "poisson", "--rate", "0.5", "--clock", "virtual", "--slo-ttft",
            "6", "--slo-e2e", "20"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv + [
        "--metrics-out", str(tmp_path / "ref.json")])
    jax_launch.main()
    launch.main(argv + ["--device", "cpu", "--metrics-out",
                        str(tmp_path / "port.json")])
    out = capsys.readouterr().out
    want = json.loads((tmp_path / "ref.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert got["report"] == want["report"]
    assert got["report"]["n_measured"] == 5
    assert "[serve] ttft: p50=" in out and "[serve] goodput:" in out
