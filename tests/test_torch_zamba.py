"""The port's zamba2 path against the reference's, on the same numpy-seeded
inputs and bridged weights (SMOKE zamba2-7b: 6 Mamba-2 layers in 2
segments of 3, d 64, d_inner 128, 8 SSM heads of 16, state 8; a shared
block of 4 heads of 16):

* the SSD recurrence's plain version against the reference oracle and the
  Pallas kernel (interpret mode), a ragged length against the oracle, and
  its in-place state update;
* the causal conv and the Mamba-2 block (prefill without and with states,
  decode), in float32 and bf16, and the float32 leaves that stay float32;
* ``HybridLM`` prefill (hidden and the whole state tree) and decode steps
  (logits and state) in float32; teacher-forced decode against prefill;
  greedy streams of an aligned batch;
* the refusals: the engine and the launcher refuse the family, a per-row
  position vector raises, int8 weights are refused.

Tolerances, as a fraction of the largest magnitude compared (at least 1):
the SSD scan against the oracle and the Pallas kernel 1e-4, as the
reference's own kernel test (tests/test_kernels.py); a float32 block 2e-5
(summation order, and the reference's chunked SSD against the port's
step-by-step recurrence); the float32 model 1e-4, since each application
of the (perturbed) shared block amplifies a gap about 16-fold: 4.3e-6 after
the first segment grows to 2.9e-5 of the prefill's hidden states, while
the shared block alone, from identical inputs, agrees to 3.5e-7; a bf16
block 2e-2 (bf16 rounds at other places in the two frameworks: about one
bf16 ulp of its O(1) output, 0.6%, was measured).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import mamba2 as JM2  # noqa: E402
from repro.models.api import build_model as jax_build_model  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_plain  # noqa: E402
from repro_torch.models import mamba2 as M2  # noqa: E402
from repro_torch.models.api import HybridLM, build_model  # noqa: E402
from repro_torch.models.module import tree_leaves  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ARCH = "zamba2-7b"
REL = {"float32": 2e-5, "bfloat16": 2e-2}
MODEL_REL = 1e-4                   # float32
SCAN_TOL = 1e-4
# the reference's kernel cases (tests/test_kernels.py): B, S, H, P, N, q_blk
SCAN_CASES = [(2, 256, 3, 16, 8, 64), (1, 128, 2, 32, 16, 128),
              (1, 512, 1, 8, 4, 32)]


def _close(got, want, rel, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    limit = rel * max(1.0, float(np.abs(want).max()))
    assert err <= limit, f"{what}: max abs err {err} > {limit}"


# ---------------------------------------------------------------------------
# the SSD recurrence
# ---------------------------------------------------------------------------

def _scan_inputs(B, S, H, P, N, seed, with_state=True):
    """The reference kernel test's distributions."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(xdt=(0.1 * rng.normal(size=(B, S, H, P))).astype(f),
                la=np.log(rng.uniform(0.8, 0.999, (B, S, H))).astype(f),
                Bm=(0.3 * rng.normal(size=(B, S, N))).astype(f),
                Cm=(0.3 * rng.normal(size=(B, S, N))).astype(f),
                state0=(0.1 * rng.normal(size=(B, H, N, P))).astype(f)
                if with_state else None)


def _torch(a):
    return {n: None if x is None else torch.from_numpy(np.array(x))
            for n, x in a.items()}


@pytest.mark.parametrize("with_state", [True, False])
@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_plain_matches_oracle_and_pallas(case, with_state):
    """The plain version against ``repro.kernels.ref.ssd_scan`` and the
    Pallas kernel (interpret mode, the case's chunk), with and without an
    initial state."""
    *shape, q_blk = case
    a = _scan_inputs(*shape, seed=sum(case), with_state=with_state)
    t = _torch(a)
    y, st = ssd_scan_plain(t["xdt"], t["la"], t["Bm"], t["Cm"], t["state0"])
    assert y.dtype == st.dtype == torch.float32
    j = {n: None if x is None else jnp.asarray(x) for n, x in a.items()}
    args = (j["xdt"], j["la"], j["Bm"], j["Cm"], j["state0"])
    for name, (jy, js) in (("oracle", jref.ssd_scan(*args)),
                           ("pallas", jops.ssd_scan(*args, q_blk=q_blk))):
        _close(y, jy, SCAN_TOL, f"y vs {name}")
        _close(st, js, SCAN_TOL, f"state vs {name}")


@pytest.mark.parametrize("bc_dtype", ["float32", "bfloat16"])
def test_scan_ragged_length_matches_oracle(bc_dtype):
    """S 200, no multiple of the TPU kernel's chunk (its wrapper refuses
    it): against the oracle alone; bf16 B and C are widened exactly on
    both sides."""
    a = _scan_inputs(2, 200, 3, 16, 8, seed=7)
    j = {n: jnp.asarray(x) for n, x in a.items()}
    t = _torch(a)
    if bc_dtype == "bfloat16":
        for n in ("Bm", "Cm"):
            j[n] = j[n].astype(jnp.bfloat16)
            t[n] = torch.tensor(np.asarray(j[n].astype(jnp.float32))
                                ).to(torch.bfloat16)
    y, st = ssd_scan_plain(t["xdt"], t["la"], t["Bm"], t["Cm"], t["state0"])
    jy, js = jref.ssd_scan(j["xdt"], j["la"], j["Bm"], j["Cm"], j["state0"])
    _close(y, jy, SCAN_TOL, "y")
    _close(st, js, SCAN_TOL, "state")


def test_scan_writes_the_state_in_place_and_counts():
    """``out_state=state0`` updates the caller's state (the decode step's
    use); a decode-shaped call (S = 1) after a prefill-shaped one equals
    one call over both; the CPU route counts as plain."""
    t = _torch(_scan_inputs(2, 65, 3, 16, 8, seed=5))
    want_y, want_s = ssd_scan_plain(t["xdt"], t["la"], t["Bm"], t["Cm"],
                                    t["state0"])
    state = t["state0"].clone()
    ops.reset_counts()
    parts = [ops.ssd_scan(t["xdt"][:, sl], t["la"][:, sl], t["Bm"][:, sl],
                          t["Cm"][:, sl], state, out_state=state)
             for sl in (slice(0, 64), slice(64, 65))]
    assert all(s is state for _, s in parts)
    assert (ops.COUNTS["ssd_scan"].plain, ops.COUNTS["ssd_scan"].kernel) \
        == (2, 0)
    ops.reset_counts()
    torch.testing.assert_close(torch.cat([y for y, _ in parts], 1), want_y,
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(state, want_s, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the Mamba-2 block
# ---------------------------------------------------------------------------

def _perturbed_params(jmodel, seed):
    """Reference init plus seeded noise, so the unit scales and ``D``, the
    zero ``A_log`` and ``dt_bias`` are exercised too; numpy leaves."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    return jax.tree.map(
        lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32),
        tree)


@pytest.fixture(scope="module")
def np_params():
    return _perturbed_params(jax_build_model(jax_smoke_config(ARCH)), seed=3)


def _pair(np_params, dtype):
    """(reference model, its params (float32), port model, bridged params
    in ``dtype`` with the float32 leaves kept float32)."""
    jmodel = jax_build_model(jax_smoke_config(ARCH).replace(remat="none",
                                                            dtype=dtype))
    model = build_model(smoke_config(ARCH).replace(dtype=dtype))
    params = params_from_numpy(np_params, device="cpu",
                               dtype=getattr(torch, dtype),
                               defs=model.param_defs())
    return jmodel, jax.tree.map(jnp.asarray, np_params), model, params


def _layer(tree, *idx):
    if isinstance(tree, dict):
        return {k: _layer(v, *idx) for k, v in tree.items()}
    return tree[idx]


def _block_inputs(cfg, S, seed, with_state):
    """x (2 rows of S tokens) and, with_state, an SSM state and the conv
    tails, float32 as the decode state keeps them."""
    rng = np.random.default_rng(seed)
    B, N, K = 2, cfg.ssm_state, cfg.conv_kernel
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    if not with_state:
        return x, None, None
    f = np.float32
    ssm = rng.normal(size=(B, cfg.ssm_heads, N, cfg.ssm_head_dim)).astype(f)
    conv = {"x": rng.normal(size=(B, K - 1, cfg.d_inner)).astype(f),
            "B": rng.normal(size=(B, K - 1, N)).astype(f),
            "C": rng.normal(size=(B, K - 1, N)).astype(f)}
    return x, ssm, conv


@pytest.mark.parametrize("S,with_state,dtype", [
    (32, False, "float32"), (12, True, "float32"), (1, True, "float32"),
    (12, True, "bfloat16"), (1, True, "bfloat16")])
def test_mamba2_block_matches_reference(np_params, S, with_state, dtype):
    """The block's output, its new SSM state (written in place) and its
    conv tails: without states (S 32), a prefill into a state (S 12) and a
    decode step (S 1); bf16 checks the float32 leaves and the casts."""
    jmodel, jp, model, params = _pair(np_params, dtype)
    cfg = model.cfg
    p, jpl = _layer(params["mamba_blocks"]["mamba"], 1, 2), \
        _layer(jp["mamba_blocks"]["mamba"], 1, 2)
    x, ssm, conv = _block_inputs(cfg, S, seed=S, with_state=with_state)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    state = None if ssm is None else torch.from_numpy(ssm.copy())
    tconv = None if conv is None else {k: torch.from_numpy(v.copy())
                                       for k, v in conv.items()}
    y, st, new_conv = M2.mamba2_block(p, tx, cfg, ssm_state=state,
                                      conv_state=tconv)
    jy, jst, jconv = JM2.mamba2_block(
        jpl, jx, jmodel.cfg, None,
        ssm_state=None if ssm is None else jnp.asarray(ssm),
        conv_state=None if conv is None else jax.tree.map(jnp.asarray, conv))
    assert y.dtype == tx.dtype and st.dtype == torch.float32
    rel = REL[dtype]
    _close(y, jnp.asarray(jy, jnp.float32), rel, "block out")
    _close(st, jst, rel, "ssm state")
    if with_state:
        assert st is state and new_conv is tconv      # written in place
        for k in "xBC":
            _close(tconv[k], jconv[k], rel, f"conv tail {k}")
    else:
        assert new_conv is None and jconv is None


def test_causal_conv_matches_reference():
    """With and without history, bf16 x against float32 weights."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 6, 24)).astype(np.float32)
    w = (0.5 * rng.normal(size=(4, 24))).astype(np.float32)
    hist = rng.normal(size=(2, 3, 24)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(torch.bfloat16)
    for h in (None, hist):
        got = M2._causal_conv(tx, torch.from_numpy(w),
                              None if h is None else torch.from_numpy(h))
        want = JM2._causal_conv(jx, jnp.asarray(w),
                                None if h is None else jnp.asarray(h))
        assert got.dtype == torch.bfloat16
        _close(got, jnp.asarray(want, jnp.float32), REL["bfloat16"],
               f"conv history={h is not None}")


F32_LEAVES = ("A_log", "D", "dt_bias", "conv_x", "conv_B", "conv_C")


def test_float32_leaves_stay_float32_at_bf16(np_params):
    """The reference reads ``A_log``, ``D``, ``dt_bias`` and the conv
    weights in float32 at any compute dtype; after init and after the
    bridge they are float32 and stacked (segments, layers, ...), every
    other leaf bf16."""
    model = build_model(smoke_config(ARCH).replace(dtype="bfloat16"))
    cfg = model.cfg
    seg, k = cfg.n_layers // cfg.shared_attn_every, cfg.shared_attn_every
    bridged = _pair(np_params, "bfloat16")[3]
    for params in (model.init(0, device="cpu"), bridged):
        m = params["mamba_blocks"]["mamba"]
        for name in F32_LEAVES:
            assert m[name].dtype == torch.float32, name
            assert m[name].shape[:2] == (seg, k), name
        assert m["w_x"].dtype == m["out_norm"]["scale"].dtype \
            == torch.bfloat16
        assert params["shared"]["attn"]["wq"].dtype == torch.bfloat16
        assert sum(t.dtype == torch.float32
                   for t in tree_leaves(params)) == len(F32_LEAVES)
    bridged_m = bridged["mamba_blocks"]["mamba"]
    np.testing.assert_array_equal(
        bridged_m["A_log"].numpy(),
        np_params["mamba_blocks"]["mamba"]["A_log"])


# ---------------------------------------------------------------------------
# the model: prefill, decode, greedy streams
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jitted():
    """The reference's prefill and decode step, jitted once per dtype."""
    cache = {}

    def get(jmodel, max_len):
        key = (jmodel.cfg.dtype, max_len)
        if key not in cache:
            cache[key] = (
                jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, None,
                                                    max_len)),
                jax.jit(lambda p, s, t, q: jmodel.decode_step(p, s, t, q,
                                                              None)))
        return cache[key]
    return get


def _state_leaves(state):
    return {"ssm": state["mamba"]["ssm"],
            **{f"conv {k}": state["mamba"]["conv"][k] for k in "xBC"},
            "k": state["attn_cache"]["k"], "v": state["attn_cache"]["v"]}


def test_prefill_and_decode_match_reference(np_params, jitted):
    """Prefill of two 10-token prompts into a 16-row cache (hidden and
    every state leaf), then three decode steps at one position (logits and
    every state leaf), in float32.  In bf16 a block differs from the
    reference's by about one bf16 ulp of its output (the block test above),
    and the shared block amplifies that to about 10% of the hidden states
    within two segments, so bf16 is held per block only."""
    dtype = "float32"
    jmodel, jp, model, params = _pair(np_params, dtype)
    jprefill, jdecode = jitted(jmodel, 16)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, model.cfg.vocab, (2, 10)).astype(np.int32)
    jst, jh = jprefill(jp, jnp.asarray(toks))
    st, h = model.prefill(params, torch.from_numpy(toks), 16)
    rel = MODEL_REL
    _close(h, jnp.asarray(jh, jnp.float32), rel, "prefill hidden")
    jleaves = _state_leaves(jst)
    for name, leaf in _state_leaves(st).items():
        assert leaf.dtype == (torch.float32 if name not in ("k", "v")
                              else getattr(torch, dtype)), name
        _close(leaf, jnp.asarray(jleaves[name], jnp.float32), rel,
               f"prefill {name}")
    for step in range(3):
        tok = rng.integers(0, model.cfg.vocab, (2, 1)).astype(np.int32)
        pos = 10 + step
        jst, jlog = jdecode(jp, jst, jnp.asarray(tok),
                            jnp.asarray(pos, jnp.int32))
        log = model.decode_step(params, st, torch.from_numpy(tok), pos)
        assert log.dtype == torch.float32
        _close(log, jlog, rel, f"decode logits step {step}")
        jleaves = _state_leaves(jst)
        for name, leaf in _state_leaves(st).items():
            _close(leaf, jnp.asarray(jleaves[name], jnp.float32), rel,
                   f"decode {name} step {step}")


def test_decode_matches_prefill(np_params):
    """Teacher forcing, as the reference's
    ``test_decode_matches_prefill[zamba2-7b]``: decoding token t from a
    state built from tokens[:t] gives the logits of prefilling
    tokens[:t+1]."""
    _, _, model, params = _pair(np_params, "float32")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab, (2, 8))
                            .astype(np.int32))
    _, hidden = model.prefill(params, toks, 12)
    want = model.lm_head(params, hidden[:, -1:])
    state, _ = model.prefill(params, toks[:, :-1], 12)
    got = model.decode_step(params, state, toks[:, -1:], torch.tensor(7))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _greedy(prefill, decode, lm_head, prompts, max_new):
    """Aligned greedy decode: the prompts' last hidden row gives token 1,
    then one decode step at one position per further token.  Returns the
    streams and, for each step, the logits' top-two gap of every row."""
    state, hidden = prefill(prompts)
    logits = np.asarray(lm_head(hidden[:, -1:]), np.float32)[:, 0]
    streams, gaps = [[] for _ in prompts], []
    for step in range(max_new):
        tok = logits.argmax(-1)
        top2 = np.sort(logits, -1)[:, -2:]
        gaps.append(top2[:, 1] - top2[:, 0])
        for row, t in zip(streams, tok):
            row.append(int(t))
        if step + 1 == max_new:
            break
        state, logits = decode(state, tok[:, None].astype(np.int32),
                               prompts.shape[1] + step)
        logits = np.asarray(logits, np.float32)[:, 0]
    return streams, np.array(gaps)


def test_greedy_streams_match_reference(jitted):
    """Three prompts of 9 tokens, 8 greedy tokens each, on the reference's
    own init: the streams equal the reference's, unless a flip is traced
    to a near-tie of the reference's logits (ROADMAP ground rules)."""
    jmodel = jax_build_model(jax_smoke_config(ARCH).replace(remat="none"))
    jp = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(smoke_config(ARCH))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                               defs=model.param_defs())
    rng = np.random.default_rng(9)
    prompts = rng.integers(0, model.cfg.vocab, (3, 9)).astype(np.int32)
    max_len = 9 + 8
    jprefill, jdecode = jitted(jmodel, max_len)
    want, gaps = _greedy(
        lambda t: jprefill(jp, jnp.asarray(t)),
        lambda s, t, q: jdecode(jp, s, jnp.asarray(t),
                                jnp.asarray(q, jnp.int32)),
        lambda h: jmodel.lm_head(jp, h, None), prompts, 8)
    ops.reset_counts()
    got, _ = _greedy(
        lambda t: model.prefill(params, torch.from_numpy(t), max_len),
        lambda s, t, q: (s, model.decode_step(params, s, torch.from_numpy(t),
                                              q)),
        lambda h: model.lm_head(params, h), prompts, 8)
    n = model.cfg.n_layers
    assert (ops.COUNTS["ssd_scan"].plain, ops.COUNTS["ssd_scan"].kernel) \
        == (n * 8, 0)                  # one prefill and 7 decode steps
    ops.reset_counts()
    for row, (g, w) in enumerate(zip(got, want)):
        first = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                     None)
        if first is not None:
            assert gaps[first, row] < 1e-4, (
                f"row {row}: streams differ at token {first} where the "
                f"reference's top-two logit gap is {gaps[first, row]}")


# ---------------------------------------------------------------------------
# what the family refuses
# ---------------------------------------------------------------------------

def test_engine_launcher_and_options_refuse_hybrid():
    model = build_model(smoke_config(ARCH))
    assert isinstance(model, HybridLM) and not model.supports_paged_decode()
    assert "aligned batch" in model.engine_refusal()
    for arch in ("qwen2-7b", "rwkv6-3b"):
        assert build_model(smoke_config(arch)).engine_refusal() is None
    params = model.init(0, device="cpu")
    for kw in ({}, {"paged": False}):
        with pytest.raises(ValueError, match=r"zamba2-7b \(hybrid\) is not "
                           r"served by the engine.*aligned batch.*"
                           r"zamba\.py:72.*serve\.py:215"):
            ServeEngine(model, params, device="cpu", **kw)
    from repro_torch.launch import serve as launch_serve
    with pytest.raises(SystemExit, match=r"zamba2-7b.*aligned batch"):
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    with pytest.raises(ValueError, match=r"refused for zamba2-7b \(hybrid\)"):
        model.init(0, device="cpu", weight_quant="int8")


def test_position_vector_raises():
    model = build_model(smoke_config(ARCH))
    params = model.init(0, device="cpu")
    state, _ = model.prefill(params, torch.tensor([[1, 2, 3], [4, 5, 6]]), 8)
    for pos in (torch.tensor([3, 3]), [3, 3], np.array([3, 3])):
        with pytest.raises(ValueError, match=r"one integer for the whole "
                           r"batch, got shape \(2,\).*aligned batch"):
            model.decode_step(params, state, torch.tensor([[7], [8]]), pos)
    fresh = model.init_decode_state(2, 8, device="cpu")
    assert fresh["mamba"]["ssm"].abs().sum() == 0
    assert fresh["attn_cache"]["k"].shape == (2, 2, 8, 4, 16)
