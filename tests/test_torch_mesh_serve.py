"""The port's serving engine on a mesh (``ServeEngine(mesh=...)``) over gloo
at worlds 2 and 4, held against the reference's single-device engine on
the same bridged SMOKE weights (float32, CPU).

The reference's own mesh tests are no parity source (several are red), so
every mesh run is compared with the reference's engine without a mesh,
which is what its passing tensor-parallel tests assert too.  Each world is
spawned once for the file (:func:`_torch_ranks.mesh_serve`, one thread a
rank); its runs (:data:`_torch_ranks.MESH_RUNS`): Megatron TP of the paged
path at tp 2 and 4 (qwen2 and qwen3-moe with 8 query / 4 KV heads; under
forced preemption, with the prefix cache, with int8 KV pages and weights,
with ngram and self-1 speculation; arctic's dense residual), expert
parallelism on ``("expert", "model")`` = (2, 1) and (2, 2), each also
with a placement every 2 ticks, slot-parallel rwkv6 and dense-path qwen2
at tp 2, the disaggregated pair and a wall-clock traffic run at tp 2.
Greedy streams equal token for token, the MoE telemetry equals the
reference's and is the same on every rank.  Then the per-call logits at
tp 2, the split MoE block bit for bit against the serial block, and the
launcher's ``--mesh``."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as R
from repro.configs import smoke_config as jax_smoke_config
from repro.models.api import build_model as jax_build_model
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import placement as JPL
from repro.serve import run_traffic as jax_run_traffic
from repro.serve.traffic import make_workload as jax_make_workload
from repro_torch.core import comm as C
from repro_torch.core.comm import SerialComm
from repro_torch.launch import serve as launch
from repro_torch.models import moe as M

MOE_STATS = ("moe_tokens_routed", "moe_dropped_tokens", "expert_tokens",
             "expert_imbalance", "placement_updates")
RUNS = [(n, case, shape) for n, runs in R.MESH_RUNS.items()
        for case, shape, _ in runs]
# per-call limit: tp sums the out-projections' head shards in another
# order than one device does (float32)
PERCALL_TOL = 1e-5
# expert TP: two float32 partial sums of the down projection added
EXPERT_TP_TOL = 1e-6


@pytest.fixture(scope="module")
def ref():
    """The reference's model and params by arch, with the params as numpy
    (what the ranks bridge)."""
    out = {}
    for arch in {case[0] for case in R.MESH_CASES.values()}:
        kw = {} if arch == "rwkv6-3b" else dict(n_heads=8, n_kv_heads=4)
        jm = jax_build_model(jax_smoke_config(arch).replace(remat="none",
                                                            **kw))
        jp = jm.init(jax.random.PRNGKey(0))
        out[arch] = (jm, jp, jax.tree.map(np.asarray, jp))
    return out


@pytest.fixture(scope="module")
def worlds(ref, tmp_path_factory):
    """world size -> every rank's :func:`_torch_ranks.mesh_serve` results
    (each world spawned once, on first use)."""
    cache = {}

    def get(n):
        if n not in cache:
            cache[n] = C.run_ranks(
                R.mesh_serve, ({a: w for a, (_, _, w) in ref.items()},),
                world=n, store_dir=tmp_path_factory.mktemp(f"mesh{n}"),
                device="cpu", timeout=600)
        return cache[n]
    return get


@pytest.fixture(scope="module")
def want(ref):
    """case -> the reference's single-device (streams, stats), on first
    use."""
    cache = {}

    def get(case):
        if case not in cache:
            arch, kw, waves, max_new = R.MESH_CASES[case]
            jm, jp, _ = ref[arch]
            eng = JaxServeEngine(jm, jp, **kw)
            for wave in waves:
                for p in wave:
                    eng.submit(p, max_new_tokens=max_new)
                eng.run_until_drained()
            eng.close()
            assert all(r.error is None for r in eng.finished)
            cache[case] = ({r.rid: r.output for r in eng.finished},
                           dict(eng.stats))
        return cache[case]
    return get


@pytest.mark.parametrize("n,case,shape", RUNS,
                         ids=[f"world{n}-{c}-{'x'.join(map(str, s))}"
                              for n, c, s in RUNS])
def test_mesh_streams_match_reference(worlds, want, n, case, shape):
    """Every rank's greedy streams equal the reference's single-device
    streams, and every rank's stats are rank 0's; the case's own counters
    (preemptions, prefix hits, drafts, the MoE telemetry) are the
    reference's."""
    res = worlds(n)
    base = case.replace("-placed", "")
    streams, stats = want(base)
    got = [r[case, shape] for r in res]
    tp, ep = shape[-1], shape[0] if len(shape) == 2 else 1
    for r, g in enumerate(got):
        assert g["streams"] == streams, (case, shape, r)
        assert g["stats"] == got[0]["stats"], (case, shape, r)
        assert (g["tp"], g["ep"]) == (tp, ep)
    s = got[0]["stats"]
    for k in ("ticks", "tokens", "preemptions", "prefix_hits",
              "cow_copies", "draft_proposed", "draft_accepted",
              "kv_bytes_per_token"):
        assert s[k] == stats[k], (case, k)
    if case.endswith("preempt"):
        assert s["preemptions"] >= 1
    if case.endswith("prefix"):
        assert s["prefix_hits"] > 0
    if "spec_decode" in R.MESH_CASES[case][1]:
        assert s["draft_proposed"] > 0
    if case == "qwen2-int8":
        assert (s["kv_quant"], s["weight_quant"]) == ("int8", "int8")
    if R.MESH_CASES[case][0] in ("qwen3-moe-235b-a22b", "arctic-480b"):
        if case == "moe-placed":
            # the plan of 2 ranks moves experts; routing does not change
            assert s["placement_updates"] >= 1
            for k in ("moe_tokens_routed", "expert_tokens"):
                assert s[k] == stats[k], k
        else:
            for k in MOE_STATS:
                if k != "expert_imbalance":
                    assert s[k] == stats[k], (case, k)
            # the imbalance is over the ep ranks' loads: the reference's
            # placement math on its own counts, at this ep
            loads = JPL.identity_plan(len(stats["expert_tokens"]), ep) \
                .rank_loads(np.asarray(stats["expert_tokens"]))
            assert s["expert_imbalance"] == JPL.imbalance(loads)
        assert s["moe_tokens_routed"] == sum(s["expert_tokens"]) > 0


def test_percall_logits_match_reference(worlds, ref):
    """tp 2: a paged prefill chunk's hidden states and the next decode
    step's logits against the reference's single-device calls on the same
    inputs, within PERCALL_TOL (float32), on both ranks."""
    jm, jp, _ = ref["qwen2-7b"]
    cfg = jm.cfg
    inp = R.percall_inputs(R.mesh_config("qwen2-7b"))
    shape = (cfg.n_layers, 9, 8, cfg.padded_kv_heads, cfg.head_dim)
    st = {"k": jnp.zeros(shape, jnp.float32),
          "v": jnp.zeros(shape, jnp.float32)}
    st, hidden, _ = jm.paged_prefill_chunk(jp, st, inp["row"],
                                           inp["row"][:2], 0, inp["chunk"],
                                           None)
    _, logits, _ = jm.paged_decode_step(jp, st, inp["tables"],
                                        inp["lengths"], inp["step"],
                                        inp["wpages"], inp["woffs"], None)
    for r in worlds(2):
        got = r["percall"]
        np.testing.assert_allclose(got["hidden"].numpy(), np.asarray(hidden),
                                   rtol=PERCALL_TOL, atol=PERCALL_TOL)
        np.testing.assert_allclose(got["logits"].numpy(), np.asarray(logits),
                                   rtol=PERCALL_TOL, atol=PERCALL_TOL)


@pytest.mark.parametrize("n,shape", [(2, (2,)), (4, (4,)), (4, (2, 2))])
def test_split_moe_block_is_serial(worlds, n, shape):
    """The MoE block with its experts split over ``"model"`` (serving TP,
    ``shard_comm``), and over both axes of a (2, 2) mesh: y, aux and the
    telemetry bit for bit the serial block's, on every rank."""
    cfg, x, w = R.moe_inputs()
    params = {k: torch.from_numpy(v) for k, v in w.items()}
    y, aux, stats = M.moe_apply_expert_parallel(
        params, torch.from_numpy(x), cfg, SerialComm())
    for r, out in enumerate(worlds(n)):
        got = out["block", shape]
        assert torch.equal(got["y"], y), r
        assert float(got["aux"]) == float(aux), r
        for k in ("tokens", "dropped"):
            assert torch.equal(got[k], stats[k]), (r, k)


def test_expert_tp_block_matches_serial(worlds):
    """Expert TP (``tp_comm``) at world 2: each expert's ff axis split over
    the ranks, the down projection's float32 partial sums all-reduced: y
    within EXPERT_TP_TOL of the serial block (the sum's order changes),
    aux and the telemetry exact, on both ranks."""
    cfg, x, w = R.moe_inputs()
    params = {k: torch.from_numpy(v) for k, v in w.items()}
    y, aux, stats = M.moe_apply_expert_parallel(
        params, torch.from_numpy(x), cfg, SerialComm())
    for out in worlds(2):
        got = out["expert-tp"]
        np.testing.assert_allclose(got["y"].numpy(), y.numpy(),
                                   rtol=EXPERT_TP_TOL, atol=EXPERT_TP_TOL)
        assert float(got["aux"]) == float(aux)
        for k in ("tokens", "dropped"):
            assert torch.equal(got[k], stats[k]), k


def test_disagg_and_wall_traffic_on_the_mesh(worlds, want, ref):
    """tp 2: the disaggregated pair (serial stages, both roles on the mesh)
    gives the reference's monolithic streams, every prefill handed off
    once; a wall-clock Poisson run (rank 0's clock deciding the arrivals)
    gives every rank the reference's virtual-clock outputs."""
    streams, _ = want("qwen2")
    jm, jp, _ = ref["qwen2-7b"]
    _, kw, _, _ = R.MESH_CASES["qwen2"]
    jeng = JaxServeEngine(jm, jp, **kw)
    jres = jax_run_traffic(jeng, jax_make_workload(vocab=jm.cfg.vocab,
                                                   **R.TRAFFIC))
    jeng.close()
    for r in worlds(2):
        d = r["disagg"]
        assert d["streams"] == streams
        assert d["handoffs"] == d["injections"] == len(streams)
        t = r["traffic-wall"]
        assert t["outputs"] == jres["outputs"]
        assert t["submits"] == R.TRAFFIC["n_requests"]


def test_launcher_mesh(capfd, tmp_path):
    """``--mesh tp=2`` on the CPU: two gloo ranks, rank 0 prints the
    summary with the reference's `` tp=2`` tag, both ranks serve the
    unmeshed launcher's streams.  On ``cuda`` with fewer cards than ranks
    it raises (no gloo fallback on a card)."""
    argv = ["--arch", "qwen2-7b", "--smoke", "--device", "cpu",
            "--requests", "4", "--max-new", "6"]
    single = launch.main(argv)
    capfd.readouterr()
    res = launch.main(argv + ["--mesh", "tp=2", "--store-dir",
                              str(tmp_path)])
    out = capfd.readouterr().out
    lines = re.findall(r"\[serve\] 4 requests, .*", out)
    assert len(lines) == 1 and " tp=2]" in lines[0], out
    want = {r.rid: r.output for r in single.finished}
    assert [(r["tp"], r["ep"]) for r in res] == [(2, 1), (2, 1)]
    assert all(r["streams"] == want for r in res)
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="NCCL ranks need"):
            launch.main(argv[:3] + ["--device", "cuda", "--mesh", "tp=2",
                                    "--store-dir", str(tmp_path)])
