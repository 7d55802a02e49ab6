"""The port's rwkv6 serving path against the reference's, on the same
numpy-seeded inputs and bridged weights (SMOKE rwkv6-3b: 2 layers, d 64,
4 heads of 16):

* the wkv recurrence's plain version against the reference oracle and the
  Pallas kernel (interpret mode), and its in-place state update;
* layernorm, time mix, channel mix and the block, call by call;
* ``RwkvLM`` prefill (state and hidden) and teacher-forced decode steps
  (state and logits) in float32 and bf16, and the float32 leaves that
  stay float32 at a bf16 compute dtype;
* the dense engine: the slot state after one padded prefill (the pad
  tokens run through the recurrence, as in the reference), greedy streams,
  the refused paged / int8 options, and the launcher on the CPU.

Tolerances, as a fraction of the largest magnitude compared (at least 1):
float32 differs by summation order and by the reference's chunked form of
the recurrence against the port's step-by-step one (2e-5; measured 2.4e-6
on the wkv state, 3.3e-6 on hidden states); bf16 rounds at other places in
the two frameworks, and one bf16 ulp of r, k or v moves the float32 state
(2e-2, about five bf16 ulps; measured 0.55% on the state, 1% on logits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import rwkv6 as JR  # noqa: E402
from repro.models import rwkv_lm as JRW  # noqa: E402
from repro.models.api import build_model as jax_build_model  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import rwkv6 as R  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.module import tree_leaves  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ARCH = "rwkv6-3b"
REL = {"float32": 2e-5, "bfloat16": 2e-2}
SCAN_REL = 1e-5          # the plain scan against the oracle: float32 only
# the reference's kernel cases (tests/test_kernels.py): B, S, H, K, V
SCAN_CASES = [(2, 128, 3, 16, 16), (1, 64, 2, 8, 8), (1, 192, 1, 32, 16)]
# 3-11 tokens run at bucket 32, 40-45 at bucket 64
PROMPTS = [[5, 17, 33, 2, 9], list(range(1, 41)), [100, 200, 300],
           [7] * 11, list(range(60, 105))]


def _close(got, want, rel, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    limit = rel * max(1.0, float(np.abs(want).max()))
    assert err <= limit, f"{what}: max abs err {err} > {limit}"


# ---------------------------------------------------------------------------
# the wkv recurrence
# ---------------------------------------------------------------------------

def _scan_inputs(case, seed, with_state=True):
    B, S, H, K, V = case
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(r=rng.normal(size=(B, S, H, K)).astype(f),
                k=(0.3 * rng.normal(size=(B, S, H, K))).astype(f),
                v=rng.normal(size=(B, S, H, V)).astype(f),
                w=rng.uniform(0.8, 0.999, (B, S, H, K)).astype(f),
                u=rng.normal(size=(H, K)).astype(f),
                state0=(0.1 * rng.normal(size=(B, H, K, V))).astype(f)
                if with_state else None)


@pytest.mark.parametrize("case,with_state,rkv_dtype", [
    (SCAN_CASES[0], True, "float32"), (SCAN_CASES[1], True, "float32"),
    (SCAN_CASES[2], True, "float32"), (SCAN_CASES[0], False, "float32"),
    (SCAN_CASES[2], True, "bfloat16")])
def test_scan_plain_matches_oracle_and_pallas(case, with_state, rkv_dtype):
    """The plain version against ``repro.kernels.ref.rwkv6_scan`` and the
    Pallas kernel (interpret mode), K == V and K != V, with and without an
    initial state; bf16 r, k, v are widened exactly on both sides."""
    a = _scan_inputs(case, seed=sum(case), with_state=with_state)
    jdt = jnp.bfloat16 if rkv_dtype == "bfloat16" else jnp.float32
    j = {n: None if x is None else jnp.asarray(x) for n, x in a.items()}
    for n in ("r", "k", "v"):
        j[n] = j[n].astype(jdt)
    t = {n: None if x is None else torch.tensor(np.asarray(
        x if n not in ("r", "k", "v") else j[n].astype(jnp.float32)))
        for n, x in a.items()}
    for n in ("r", "k", "v"):
        t[n] = t[n].to(getattr(torch, rkv_dtype))
    y, st = rwkv6_scan_plain(t["r"], t["k"], t["v"], t["w"], t["u"],
                             t["state0"])
    assert y.dtype == st.dtype == torch.float32
    args = (j["r"], j["k"], j["v"], j["w"], j["u"], j["state0"])
    for name, (jy, js) in (("oracle", jref.rwkv6_scan(*args)),
                           ("pallas", jops.rwkv6_scan(*args))):
        _close(y, jy, SCAN_REL, f"y vs {name}")
        _close(st, js, SCAN_REL, f"state vs {name}")


def test_scan_writes_the_state_in_place_and_counts():
    """``out_state=state0`` updates the caller's state (the decode step's
    use); a decode-shaped call (S = 1) after a prefill-shaped one equals
    one call over both; the CPU route counts as plain."""
    a = _scan_inputs(SCAN_CASES[0], seed=5)
    t = {n: torch.from_numpy(x) for n, x in a.items()}
    want_y, want_s = rwkv6_scan_plain(t["r"], t["k"], t["v"], t["w"], t["u"],
                                      t["state0"])
    state = t["state0"].clone()
    ops.reset_counts()
    y1, s1 = ops.rwkv6_scan(t["r"][:, :-1], t["k"][:, :-1], t["v"][:, :-1],
                            t["w"][:, :-1], t["u"], state, out_state=state)
    y2, s2 = ops.rwkv6_scan(t["r"][:, -1:], t["k"][:, -1:], t["v"][:, -1:],
                            t["w"][:, -1:], t["u"], state, out_state=state)
    assert s1 is state and s2 is state
    assert ops.COUNTS["rwkv6_scan"].plain == 2
    assert ops.COUNTS["rwkv6_scan"].kernel == 0
    ops.reset_counts()
    torch.testing.assert_close(torch.cat([y1, y2], 1), want_y, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(state, want_s, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# layers and blocks, call by call
# ---------------------------------------------------------------------------

def _perturbed_params(jmodel, seed):
    """Reference init plus seeded noise, so the unit scales, zero biases and
    zero ``decay_base`` are exercised too; numpy leaves."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    return jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        tree)


@pytest.fixture(scope="module")
def np_params():
    return _perturbed_params(jax_build_model(jax_smoke_config(ARCH)), seed=3)


def _pair(np_params, dtype):
    """(reference cfg, reference params (float32), port model, bridged
    params in ``dtype`` with the float32 leaves kept float32)."""
    jcfg = jax_smoke_config(ARCH).replace(remat="none", dtype=dtype)
    model = build_model(smoke_config(ARCH).replace(dtype=dtype))
    params = params_from_numpy(np_params, device="cpu",
                               dtype=getattr(torch, dtype),
                               defs=model.param_defs())
    return jcfg, jax.tree.map(jnp.asarray, np_params), model, params


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(np_params, dtype):
    _, jp, _, params = _pair(np_params, dtype)
    rng = np.random.default_rng(1)
    x = (3 * rng.normal(size=(2, 5, 64)) + 1).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    p = _layer(params["blocks"]["ln1"], 0)
    got = L.layernorm(p, tx)
    assert got.dtype == tx.dtype
    _close(got, JL.layernorm(_layer(jp["blocks"]["ln1"], 0), jx).astype(
        jnp.float32), REL[dtype], "layernorm")


def _block_inputs(jcfg, S, seed, with_state):
    """x (1 or 2 rows of S tokens), and with_state: a wkv state and the two
    shift buffers, float32 as the decode state keeps them."""
    rng = np.random.default_rng(seed)
    B, d, H, hd = 2, jcfg.d_model, jcfg.rwkv_heads, jcfg.rwkv_head_dim
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    if not with_state:
        return x, None, None, None
    return (x, (rng.normal(size=(B, H, hd, hd))).astype(np.float32),
            rng.normal(size=(B, 1, d)).astype(np.float32),
            rng.normal(size=(B, 1, d)).astype(np.float32))


def _to(x, dtype):
    """A fresh tensor (the port writes states in place; numpy's stays)."""
    return None if x is None else torch.tensor(np.asarray(x), dtype=dtype)


@pytest.mark.parametrize("S,with_state", [(32, False), (5, True), (1, True),
                                          (32, True)])
def test_time_mix_channel_mix_and_block_match_reference(np_params, S,
                                                        with_state):
    """S 32 runs the reference's chunked form, 5 and 1 its scan; the port
    runs the recurrence step by step in every case (float32)."""
    jcfg, jp, model, params = _pair(np_params, "float32")
    p, jpl = _layer(params["blocks"], 1), _layer(jp["blocks"], 1)
    x, wkv, tmp, cmp = _block_inputs(jcfg, S, seed=S, with_state=with_state)
    jarg = (lambda a: None if a is None else jnp.asarray(a))
    f32 = torch.float32

    state = _to(wkv, f32)
    out, st, last = R.time_mix(p["tm"], _to(x, f32), model.cfg, state=state,
                               x_prev=_to(tmp, f32))
    jout, jst, jlast = JR.time_mix(jpl["tm"], jnp.asarray(x), jcfg, None,
                                   state=jarg(wkv), x_prev=jarg(tmp))
    _close(out, jout, REL["float32"], "time_mix out")
    _close(st, jst, REL["float32"], "time_mix state")
    _close(last, jlast, 0, "time_mix last_x")
    if with_state:
        assert st is state                       # written in place

    out, last = R.channel_mix(p["cm"], _to(x, f32), x_prev=_to(cmp, f32))
    jout, jlast = JR.channel_mix(jpl["cm"], jnp.asarray(x), x_prev=jarg(cmp))
    _close(out, jout, REL["float32"], "channel_mix out")
    _close(last, jlast, 0, "channel_mix last_x")

    got = R.rwkv_block(p, _to(x, f32), model.cfg, tm_state=_to(wkv, f32),
                       tm_prev=_to(tmp, f32), cm_prev=_to(cmp, f32))
    want = JR.rwkv_block(jpl, jnp.asarray(x), jcfg, None, tm_state=jarg(wkv),
                         tm_prev=jarg(tmp), cm_prev=jarg(cmp))
    for what, g, w in zip(("x", "wkv", "tm_prev", "cm_prev"), got, want):
        _close(g, w, REL["float32"], f"rwkv_block {what}")


# ---------------------------------------------------------------------------
# the model: prefill and teacher-forced decode
# ---------------------------------------------------------------------------

F32_LEAVES = (("blocks", "ln1", "scale"), ("blocks", "ln2", "bias"),
              ("blocks", "tm", "decay_base"), ("blocks", "tm", "u"),
              ("blocks", "tm", "ln_x", "scale"), ("blocks", "tm", "w_o"),
              ("ln_in", "scale"), ("final_norm", "bias"))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_float32_leaves_stay_float32_at_bf16(np_params):
    """Finding: the reference reads the norms, ``u``, ``decay_base`` and
    ``w_o`` in float32 at any compute dtype; after init and after the
    bridge they are float32, every other leaf bf16."""
    model = build_model(smoke_config(ARCH).replace(dtype="bfloat16"))
    bridged = _pair(np_params, "bfloat16")[3]
    for params in (model.init(0, device="cpu"), bridged):
        for path in F32_LEAVES:
            assert _get(params, path).dtype == torch.float32, path
        assert params["blocks"]["tm"]["w_r"].dtype == torch.bfloat16
        assert params["embed"]["table"].dtype == torch.bfloat16
        n32 = sum(t.dtype == torch.float32 for t in tree_leaves(params))
        # stacked: ln1, ln2, ln_x (scale, bias), decay_base, u, w_o; then
        # ln_in and final_norm (scale, bias)
        assert n32 == 13
    # without the declarations every leaf takes the one dtype
    plain = params_from_numpy(np_params, device="cpu", dtype=torch.bfloat16)
    assert plain["blocks"]["tm"]["u"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(np_params, dtype):
    """Prefill of two 32-token prompts (state and hidden), then three
    teacher-forced decode steps (state and logits)."""
    jcfg, jp, model, params = _pair(np_params, dtype)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab, (2, 32)).astype(np.int32)
    jst, jh = JRW.prefill(jp, jcfg, None, jnp.asarray(toks))
    st, h = model.prefill(params, torch.from_numpy(toks))
    rel = REL[dtype]
    _close(h, jnp.asarray(jh, jnp.float32), rel, "prefill hidden")
    for leaf in ("wkv", "tm_prev", "cm_prev"):
        assert st[leaf].dtype == torch.float32
        _close(st[leaf], jst[leaf], rel, f"prefill {leaf}")
    for step in range(3):
        tok = rng.integers(0, jcfg.vocab, (2, 1)).astype(np.int32)
        jst, jlog = JRW.decode_step(jp, jcfg, None, jst, jnp.asarray(tok),
                                    step)
        log = model.decode_step(params, st, torch.from_numpy(tok), step)
        assert log.dtype == torch.float32
        _close(log, jlog, rel, f"decode logits step {step}")
        for leaf in ("wkv", "tm_prev", "cm_prev"):
            _close(st[leaf], jst[leaf], rel, f"decode {leaf} step {step}")


# ---------------------------------------------------------------------------
# the dense engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines_pair():
    jmodel = jax_build_model(jax_smoke_config(ARCH).replace(remat="none"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(smoke_config(ARCH))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu", defs=model.param_defs())
    return jmodel, jparams, model, params


def test_padded_prefill_state_equals_reference(engines_pair):
    """One 5-token prompt, right-padded to bucket 32 by both engines: the
    slot state equals the reference's, and differs from an unpadded
    prefill's (the pad tokens ran through the recurrence, as in the
    reference)."""
    jmodel, jparams, model, params = engines_pair
    prompt = [5, 17, 33, 2, 9]
    eng = ServeEngine(model, params, max_slots=2, max_len=64, device="cpu")
    jeng = JaxServeEngine(jmodel, jparams, max_slots=2, max_len=64)
    assert not eng.paged and not jeng.paged
    for e in (eng, jeng):
        e.submit(prompt, max_new_tokens=1)      # retires at its first token
        e.run_until_drained()
    assert eng.finished[0].output == jeng.finished[0].output
    for leaf in ("wkv", "tm_prev", "cm_prev"):
        _close(eng.state[leaf], jeng.state[leaf], REL["float32"],
               f"slot state {leaf}")
    unpadded, _ = model.prefill(params, torch.tensor([prompt]))
    gap = (eng.state["wkv"][:, 0] - unpadded["wkv"][:, 0]).abs().max()
    assert gap > 0.1 * unpadded["wkv"].abs().max()
    eng.close()


@pytest.mark.parametrize("prefill_workers", [1, 4])
def test_streams_match_reference(engines_pair, prefill_workers):
    """Five prompts over buckets 32 and 64 on two slots (so ``write_slot``
    reuses slots): the greedy streams and counts equal the reference's."""
    jmodel, jparams, model, params = engines_pair
    kw = dict(max_slots=2, max_len=96)
    jeng = JaxServeEngine(jmodel, jparams, prefill_workers=2, **kw)
    eng = ServeEngine(model, params, device="cpu",
                      prefill_workers=prefill_workers, **kw)
    for e in (jeng, eng):
        for p in PROMPTS:
            e.submit(p, max_new_tokens=6)
        e.run_until_drained()
    assert all(r.error is None for r in eng.finished)
    assert {r.rid: r.output for r in eng.finished} \
        == {r.rid: r.output for r in jeng.finished}
    for k in ("ticks", "tokens", "prefills"):
        assert eng.stats[k] == jeng.stats[k], k
    assert eng.pool is None
    eng.close()


def test_paged_and_int8_options_refused(engines_pair):
    _, _, model, params = engines_pair
    with pytest.raises(ValueError, match=r"rwkv6-3b \(ssm\) has no paged KV"):
        ServeEngine(model, params, device="cpu", paged=True)
    with pytest.raises(ValueError, match=r"kv_quant='int8'.*rwkv6-3b \(ssm\)"):
        ServeEngine(model, params, device="cpu", kv_quant="int8")
    with pytest.raises(ValueError,
                       match=r"paged serving path only: rwkv6-3b \(ssm\)"):
        ServeEngine(model, params, device="cpu", weight_quant="int8")
    with pytest.raises(ValueError, match=r"refused for rwkv6-3b \(ssm\)"):
        model.init(0, device="cpu", weight_quant="int8")


def test_launcher_serves_rwkv_on_cpu(capsys):
    from repro_torch.launch import serve as launch_serve
    eng = launch_serve.main(["--arch", "rwkv6-3b", "--smoke", "--device",
                             "cpu", "--requests", "3", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "[dense]" in out and "rwkv6_scan: launches=0 plain=" in out
    assert not eng.paged and len(eng.finished) == 3
    assert all(len(r.output) == 4 for r in eng.finished)
    s = eng.stats
    n_layers = smoke_config(ARCH).n_layers
    assert ops.COUNTS["rwkv6_scan"].plain \
        == n_layers * (s["prefills"] + s["ticks"])
    assert ops.COUNTS["rwkv6_scan"].kernel == 0
    assert all(c.kernel == c.plain == 0 for n, c in ops.COUNTS.items()
               if n != "rwkv6_scan")
