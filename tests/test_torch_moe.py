"""The port's MoE block, expert placement and MoE decoder against the
reference's, on the CPU at SMOKE size.

* ``capacity``'s edge cases and the block's parameter shapes;
* ``_dispatch_compute_combine`` on the same numpy inputs: y within 1e-5 in
  float32 (summation order) and within one bf16 step (2**-7) in bf16, the
  auxiliary loss within 1e-6, the per-expert telemetry exact; with
  ``capacity_factor`` 0.5 (drops), the identity map, and an ep-4 plan that
  replicates a hot expert and evicts unrouted ones, applied serially (then
  equal to the unplaced block bit for bit);
* the placement module's plans array for array, and ``apply_placement``;
* per call, bridged qwen3-moe and arctic SMOKE weights: the paged prefill
  chunk's hidden states, the decode step's and the verify window's logits
  (1e-4, float32) and page storage, and their telemetry exact; the dense
  per-slot path's prefill and decode;
* ``moe_apply_expert_parallel`` at worlds 2 and 4 over gloo (each world
  spawned once for this file) equal to the serial block bit for bit,
  unplaced and under the world's plan.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as R
from repro.configs import smoke_config as jax_smoke_config
from repro.core.comm import SerialComm as JaxSerialComm
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.api import build_model as jax_build_model
from repro.serve import placement as JPL
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import smoke_config
from repro_torch.core import comm as C
from repro_torch.core.comm import SerialComm
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.api import build_model
from repro_torch.serve import placement as PL

ARCHS = ("qwen3-moe-235b-a22b", "arctic-480b")
ATOL = 1e-4          # float32 model calls: only summation order differs
Y_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
PS, N_PAGES = 8, 10


def test_capacity_edge_cases():
    """The reference's cases: cf scales the balanced budget, the floor is
    4, multiples of 4, top_k > n_experts refused."""
    assert M.capacity(64, 4, 8, 1.0) == 32
    assert M.capacity(64, 4, 8, 1.25) == 40
    assert M.capacity(64, 4, 8, 0.5) == 16
    assert M.capacity(1, 4, 8, 1.25) == 4
    assert M.capacity(0, 2, 8, 1.0) == 4
    for args in ((64, 4, 8, 1.25), (7, 8, 128, 1.25), (1000, 2, 128, 1.0)):
        assert M.capacity(*args) == JM.capacity(*args)
    with pytest.raises(ValueError, match="top_k=9 > n_experts=8"):
        M.capacity(16, 9, 8, 1.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_reference(arch):
    """Every leaf of the decoder's tree, the MoE block's included (arctic
    keeps its dense MLP beside the experts), has the reference's shape."""
    defs = build_model(smoke_config(arch)).param_defs()
    jdefs = jax_build_model(jax_smoke_config(arch)).param_defs()

    def shapes(tree, leaf_shape):
        if isinstance(tree, dict):
            return {k: shapes(v, leaf_shape) for k, v in tree.items()}
        return tuple(leaf_shape(tree))

    assert shapes(defs, lambda p: p.shape) == shapes(jdefs,
                                                     lambda p: p.shape)
    block = M.moe_def(smoke_config(arch))
    cfg = smoke_config(arch)
    E, d, eff = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    assert {k: tuple(p.shape) for k, p in block.items()} == {
        "router": (d, E), "gate": (E, d, eff), "up": (E, d, eff),
        "down": (E, eff, d)}
    assert ("mlp" in defs["blocks"]) == cfg.dense_residual


def _block_pair(cfg, x, w, dtype, placement=None, perm=None):
    """The port's and the reference's block on the same inputs, weights in
    ``dtype`` (the router in float32), expert stacks permuted by ``perm``."""
    jdt = jnp.dtype(str(dtype).split(".")[-1])
    idx = np.arange(cfg.n_experts) if perm is None else perm
    exp = {k: w[k][idx] for k in ("gate", "up", "down")}
    t = torch.from_numpy
    got = M._dispatch_compute_combine(
        t(x).to(dtype), t(w["router"]), *(t(exp[k]).to(dtype)
                                          for k in ("gate", "up", "down")),
        cfg, SerialComm(),
        placement=None if placement is None else t(placement))
    jcfg = jax_smoke_config(cfg.name).replace(
        capacity_factor=cfg.capacity_factor)
    want = JM._dispatch_compute_combine(
        jnp.asarray(x).astype(jdt), jnp.asarray(w["router"]),
        *(jnp.asarray(exp[k]).astype(jdt) for k in ("gate", "up", "down")),
        jcfg, JaxSerialComm(),
        placement=None if placement is None else jnp.asarray(placement))
    return got, want


def _same_block(got, want, dtype):
    y, aux, stats = got
    jy, jaux, jstats = want
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)), rtol=0,
                               atol=Y_TOL[dtype])
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)
    for k in ("tokens", "dropped"):
        assert stats[k].dtype == torch.int32
        np.testing.assert_array_equal(stats[k].numpy(), np.asarray(jstats[k]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_matches_reference(arch, cf, dtype):
    """y, aux and the telemetry against the reference's block; cf 0.5 drops
    assignments, and the drops are the reference's exactly."""
    cfg = smoke_config(arch).replace(capacity_factor=cf)
    _, x, w = R.moe_inputs(arch)
    got, want = _block_pair(cfg, x, w, dtype)
    _same_block(got, want, dtype)
    if cf < 1:
        assert int(got[2]["dropped"].sum()) > 0
    # the identity map gives the unplaced integer slots: bit for bit
    ident, _ = _block_pair(cfg, x, w, dtype,
                           placement=M.identity_placement(cfg.n_experts))
    assert torch.equal(ident[0], got[0]) and float(ident[1]) == float(got[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ep4_plan_applied_serially(dtype):
    """An ep-4 plan from the block's own counts replicates the hottest
    expert and evicts the two unrouted ones; applied serially (weights
    permuted, dispatch map) it equals the reference's placed block, and
    the unplaced block bit for bit (each capacity row is computed once,
    whichever slot holds it)."""
    cfg, x, w = R.moe_inputs()
    plan = R.moe_plan(cfg, x, w, 4)
    assert (plan.split_q > 0).any() and (plan.slot_a < 0).any()
    assert set(np.flatnonzero(plan.slot_a < 0)) <= {cfg.n_experts - 2,
                                                    cfg.n_experts - 1}
    got, want = _block_pair(cfg, x, w, dtype,
                            placement=plan.dispatch_arrays(),
                            perm=plan.phys_expert)
    _same_block(got, want, dtype)
    unplaced, _ = _block_pair(cfg, x, w, dtype)
    assert torch.equal(got[0], unplaced[0])
    for k in ("tokens", "dropped"):
        assert torch.equal(got[2][k], unplaced[2][k])


# ---------------------------------------------------------------------------
# placement plans
# ---------------------------------------------------------------------------

PLAN_CASES = [([1000, 900, 10, 10, 10, 10, 10, 10], 2, {}),
              ([5000, 0, 10, 10, 0, 10, 10, 10], 2, {}),
              ([5000, 0, 10, 10, 0, 10, 10, 10], 4, {}),
              ([5000, 0, 10, 10, 0, 10, 10, 10], 2, {"replicate": False}),
              ([300, 300, 300, 300, 20, 20, 20, 20], 2,
               {"rank_time_per_token": [1.0, 2.0]}),
              ([40, 30, 0, 10, 12, 0, 9, 11], 2, {}),
              ([0] * 8, 4, {}),
              (list(range(16)), 1, {})]


@pytest.mark.parametrize("case", range(len(PLAN_CASES)))
def test_plans_match_reference(case):
    """plan_placement array for array (skew, replication and eviction,
    replicate=False, heterogeneous ranks, an idle window, ep 1); rank loads
    and imbalance of the plan and of the identity plan; dispatch arrays."""
    counts, ep, kw = PLAN_CASES[case]
    got, want = PL.plan_placement(counts, ep, **kw), \
        JPL.plan_placement(counts, ep, **kw)
    for f in ("phys_expert", "slot_a", "slot_b", "split_q"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    np.testing.assert_array_equal(got.dispatch_arrays(),
                                  want.dispatch_arrays())
    for g, j in ((got, want), (PL.identity_plan(len(counts), ep),
                               JPL.identity_plan(len(counts), ep))):
        np.testing.assert_array_equal(g.rank_loads(counts),
                                      j.rank_loads(counts))
        assert PL.imbalance(g.rank_loads(counts)) == \
            JPL.imbalance(j.rank_loads(counts))
    assert PL.imbalance([]) == 1.0
    np.testing.assert_array_equal(PL.identity_plan(8, 2).dispatch_arrays(),
                                  M.identity_placement(8))
    with pytest.raises(ValueError, match="not divisible"):
        PL.plan_placement([1, 2, 3], ep=2)


def test_apply_placement_permutes_expert_stacks():
    """A permutation of the expert axis of the stacked gate/up/down (an int8
    leaf's codes only); the router and every other leaf untouched; the
    source tree unchanged; unassigned slots and dense trees refused."""
    g = torch.Generator().manual_seed(0)
    gate = torch.randn(2, 4, 3, 5, generator=g)
    down = torch.randn(2, 4, 5, 3, generator=g)
    q8 = {"q8": torch.randint(-127, 127, (2, 4, 3, 5), generator=g,
                              dtype=torch.int8),
          "s8": torch.tensor(0.02)}
    router = torch.randn(2, 3, 4, generator=g)
    params = {"blocks": {"attn": "keep", "moe": {
        "router": router, "gate": gate, "up": q8, "down": down}}}
    perm = np.array([2, 0, 3, 1])
    plan = PL.PlacementPlan(4, 2, perm, np.argsort(perm), np.argsort(perm),
                            np.zeros(4, np.int64))
    out = PL.apply_placement(params, plan)["blocks"]
    assert torch.equal(out["moe"]["gate"], gate[:, perm])
    assert torch.equal(out["moe"]["down"], down[:, perm])
    assert torch.equal(out["moe"]["up"]["q8"], q8["q8"][:, perm])
    assert out["moe"]["up"]["s8"] is q8["s8"]
    assert out["moe"]["router"] is router and out["attn"] == "keep"
    assert params["blocks"]["moe"]["gate"] is gate
    bad = PL.PlacementPlan(4, 2, np.array([2, 0, 3, -1]), perm, perm,
                           np.zeros(4, np.int64))
    with pytest.raises(ValueError, match="unassigned"):
        PL.apply_placement(params, bad)
    with pytest.raises(ValueError, match="no expert-stacked"):
        PL.apply_placement({"blocks": {"attn": "x"}}, plan)


# ---------------------------------------------------------------------------
# the MoE decoder, call by call
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    """(reference config, numpy params, port model, bridged params): the
    reference's init plus seeded noise, so the unit norm scales are
    exercised too."""
    jcfg = jax_smoke_config(request.param).replace(remat="none")
    jmodel = jax_build_model(jcfg)
    rng = np.random.default_rng(3)
    np_params = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape)
                   ).astype(np.float32),
        jmodel.init(jax.random.PRNGKey(0)))
    model = build_model(smoke_config(request.param))
    return jcfg, np_params, model, params_from_numpy(np_params, device="cpu")


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL, err_msg=what)


def _same_tel(tel, jtel, what):
    for k in ("expert_tokens", "expert_dropped"):
        assert tel[k].dtype == torch.int32, what
        np.testing.assert_array_equal(tel[k].numpy(), np.asarray(jtel[k]),
                                      err_msg=f"{what} {k}")


def test_bridge_keeps_moe_leaves(models):
    """The bridged tree equals the reference's leaf for leaf: the router,
    the (L, E, d, eff) / (L, E, eff, d) expert stacks, arctic's MLP."""
    jcfg, np_params, model, params = models
    blocks = params["blocks"]
    E, d, eff = jcfg.n_experts, jcfg.d_model, jcfg.expert_d_ff
    assert blocks["moe"]["gate"].shape == (jcfg.n_layers, E, d, eff)
    assert blocks["moe"]["down"].shape == (jcfg.n_layers, E, eff, d)
    assert ("mlp" in blocks) == jcfg.dense_residual
    for name in blocks["moe"]:
        np.testing.assert_array_equal(blocks["moe"][name].numpy(),
                                      np_params["blocks"]["moe"][name])


@pytest.mark.parametrize("placed", [False, True], ids=["unplaced", "plan"])
def test_paged_calls_match_reference(models, placed):
    """Two prefill chunks into one slot (the second right-padded, its pad
    rows routed), three decode steps beside a dead slot writing the trash
    page, then a verify window of 3 a slot: the hidden states and logits,
    both storage leaves and the telemetry after every call.  ``plan``: the
    same calls under an ep-2 plan of a window (weights permuted, dispatch
    map), on both sides."""
    jcfg, np_params, model, params = models
    jmodel = jax_build_model(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    E = jcfg.n_experts
    jpl = tpl = None
    if placed:
        counts = np.arange(E)[::-1] * 7 + 1
        plan = PL.plan_placement(counts, 2)
        np_params = JPL.apply_placement(np_params, plan)
        jparams = jax.tree.map(jnp.asarray, np_params)
        params = params_from_numpy(np_params, device="cpu")
        jpl = jnp.asarray(plan.dispatch_arrays())
        tpl = torch.from_numpy(plan.dispatch_arrays())
    rng = np.random.default_rng(7)
    shape = (jcfg.n_layers, N_PAGES + 1, PS, jcfg.n_kv_heads, jcfg.head_dim)
    jst = {"k": jnp.zeros(shape), "v": jnp.zeros(shape)}
    tst = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    table = np.array([3, 1, 5, 0, 6, 2], np.int32)
    prompt = rng.integers(0, jcfg.vocab, 27).astype(np.int32)
    C = 2 * PS
    for start in (0, C):
        toks = np.zeros((1, C), np.int32)
        valid = min(C, len(prompt) - start)
        toks[0, :valid] = prompt[start:start + valid]
        pages = table[start // PS:(start + C) // PS]
        jst, jh, jtel = jmodel.paged_prefill_chunk(
            jparams, jst, jnp.asarray(table), jnp.asarray(pages),
            np.int32(start), jnp.asarray(toks), None, placement=jpl)
        th, tel = model.paged_prefill_chunk(
            params, tst, torch.from_numpy(table), torch.from_numpy(pages),
            start, torch.from_numpy(toks), placement=tpl)
        _close(th, jh, f"prefill hidden @ {start}")
        _same_tel(tel, jtel, f"prefill @ {start}")
        assert int(tel["expert_tokens"].sum()) == \
            C * jcfg.top_k * jcfg.n_layers
        for leaf in ("k", "v"):
            _close(tst[leaf], jst[leaf], f"prefill {leaf} @ {start}")

    tables = np.stack([table, np.zeros_like(table)])
    tok = np.array([[int(prompt[-1])], [0]], np.int32)
    ln = len(prompt)
    for step in range(3):
        lengths = np.array([ln, 0], np.int32)
        wpages = np.array([table[ln // PS], N_PAGES], np.int32)
        woffs = np.array([ln % PS, 0], np.int32)
        args = (tables, lengths, tok, wpages, woffs)
        jst, jlog, jtel = jmodel.paged_decode_step(
            jparams, jst, *map(jnp.asarray, args), None, placement=jpl)
        tlog, tel = model.paged_decode_step(
            params, tst, *map(torch.from_numpy, args), placement=tpl)
        _close(tlog[:1], jlog[:1], f"decode logits step {step}")
        _same_tel(tel, jtel, f"decode step {step}")   # the dead slot too
        for leaf in ("k", "v"):
            _close(tst[leaf], jst[leaf], f"decode {leaf} step {step}")
        tok = np.array([[int(np.argmax(np.asarray(jlog)[0, 0]))], [0]],
                       np.int32)
        ln += 1

    W = 3
    toks = np.zeros((2, W), np.int32)
    toks[0] = [tok[0, 0], 5, 9]
    lengths = np.array([ln, 0], np.int32)
    wpages = np.full((2, W), N_PAGES, np.int32)
    woffs = np.zeros((2, W), np.int32)
    for i in range(W):
        wpages[0, i] = table[(ln + i) // PS]
        woffs[0, i] = (ln + i) % PS
    args = (tables, lengths, toks, wpages, woffs)
    jst, jlog, jtel = jmodel.paged_verify(
        jparams, jst, *map(jnp.asarray, args), None, placement=jpl)
    tlog, tel = model.paged_verify(params, tst, *map(torch.from_numpy, args),
                                   placement=tpl)
    _close(tlog[:1], jlog[:1], "verify logits")
    _same_tel(tel, jtel, "verify")
    for leaf in ("k", "v"):
        _close(tst[leaf], jst[leaf], f"verify {leaf}")


def test_dense_path_matches_reference(models):
    """The dense per-slot path: whole-prompt prefill of two right-padded
    prompts (the serial MoE block over every row, pad included), then
    ragged decode steps: hidden states, logits and the cache."""
    jcfg, np_params, model, params = models
    jmodel = jax_build_model(jcfg)
    jparams = jax.tree.map(jnp.asarray, np_params)
    rng = np.random.default_rng(13)
    S, max_len = 24, 40
    toks = rng.integers(0, jcfg.vocab, (2, S)).astype(np.int32)
    lens = np.array([17, 24], np.int32)
    toks[0, lens[0]:] = 0
    jcache, jh = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                None, max_len)
    cache, h = model.prefill(params, torch.from_numpy(toks), max_len)
    _close(h, jh, "prefill hidden")
    pos = lens.copy()
    tok = np.array([[3], [7]], np.int32)
    for step in range(3):
        jcache, jlog = jmodel.decode_step(jparams, jcache, jnp.asarray(tok),
                                          jnp.asarray(pos), None)
        tlog = model.decode_step(params, cache, torch.from_numpy(tok),
                                 torch.from_numpy(pos))
        _close(tlog, jlog, f"decode logits step {step}")
        for leaf in ("k", "v"):
            _close(cache[leaf], jcache[leaf], f"decode {leaf} step {step}")
        tok = np.argmax(np.asarray(jlog)[:, 0], -1)[:, None].astype(np.int32)
        pos = pos + 1


def test_dense_model_telemetry_is_empty():
    """A dense model's paged calls return (0,)-shaped telemetry."""
    model = build_model(smoke_config("qwen2-7b"))
    cfg = model.cfg
    params = model.init(0, device="cpu")
    shape = (cfg.n_layers, 3, PS, cfg.n_kv_heads, cfg.head_dim)
    st = {"k": torch.zeros(shape), "v": torch.zeros(shape)}
    row = torch.tensor([0, 1], dtype=torch.int32)
    _, tel = model.paged_prefill_chunk(params, st, row, row, 0,
                                       torch.arange(2 * PS)[None])
    assert {k: tuple(v.shape) for k, v in tel.items()} == {
        "expert_tokens": (0,), "expert_dropped": (0,)}
    assert T.block_defs(cfg).keys() == {"ln1", "attn", "ln2", "mlp"}
    assert JT.block_defs(jax_smoke_config("qwen2-7b")).keys() == \
        T.block_defs(cfg).keys()


# ---------------------------------------------------------------------------
# expert parallelism over gloo
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=(2, 4), ids=lambda n: f"world{n}")
def ep_world(request, tmp_path_factory):
    n = request.param
    store = tmp_path_factory.mktemp(f"ep{n}")
    return n, C.run_ranks(R.moe_expert_parallel, world=n, store_dir=store,
                          device="cpu", timeout=300)


def test_expert_parallel_equals_serial(ep_world):
    """Every rank's y, aux and telemetry equal the serial block's bit for
    bit, unplaced and under the world's plan (each rank holds E/ep
    experts; the dispatch buffer goes through Comm.all_to_all)."""
    n, res = ep_world
    cfg, x, w = R.moe_inputs()
    for label, plan in (("unplaced", None),
                        ("placed", R.moe_plan(cfg, x, w, n))):
        params, placement = R.placed_block(w, plan)
        y, aux, stats = M.moe_apply_expert_parallel(
            params, torch.from_numpy(x), cfg, SerialComm(),
            placement=placement)
        for r, out in enumerate(res):
            got = out[label]
            assert torch.equal(got["y"], y), (label, r)
            assert float(got["aux"]) == float(aux), (label, r)
            for k in ("tokens", "dropped"):
                assert torch.equal(got[k], stats[k]), (label, r, k)
