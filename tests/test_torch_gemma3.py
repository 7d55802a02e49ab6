"""The port's gemma3-4b path against the reference's, on the same
numpy-seeded inputs and bridged weights (SMOKE gemma3-4b, float32: 3
layers, the last global and the first two sliding-window layers of window
8, d 64, 4/2 heads of 16, QK-norm):

* ``gqa_attention`` over a ring of keys (``k_start``: keys at negative
  positions masked, the sliding window) against the reference's;
* ``prefill``'s mixed cache: the global layers' ``k``/``v`` and the rings
  ``k_loc``/``v_loc`` (right-aligned, a prompt shorter than the ring
  left-padded with zeros), and the hidden states;
* aligned decode steps (logits and all four cache leaves) over W + 6
  steps, across the ring's wrap, from prompts shorter and longer than W;
* greedy aligned streams; teacher-forced decode against prefill;
* the refusals: the engines and the launcher refuse the model with the
  reference's aligned-only decode named, a per-row position vector raises.

Tolerance 1e-5 of the largest magnitude compared (at least 1): float32 on
both sides, summation order only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models.api import build_model as jax_build_model  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.api import DecoderLM, build_model  # noqa: E402
from repro_torch.serve.disagg import DisaggServeEngine  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

ARCH = "gemma3-4b"
REL = 1e-5
W = 8                                  # SMOKE's local_window


def _close(got, want, what, rel=REL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    limit = rel * max(1.0, float(np.abs(want).max()))
    assert err <= limit, f"{what}: max abs err {err} > {limit}"


@pytest.fixture(scope="module")
def pair():
    """(reference model, its params, port model, bridged float32 params),
    on the reference's own init plus seeded noise (so the unit norm scales
    are exercised too)."""
    jmodel = jax_build_model(jax_smoke_config(ARCH).replace(remat="none"))
    rng = np.random.default_rng(3)
    tree = jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape))
        .astype(np.float32), jmodel.init(jax.random.PRNGKey(0)))
    model = build_model(smoke_config(ARCH))
    params = params_from_numpy(tree, device="cpu", defs=model.param_defs())
    return jmodel, jax.tree.map(jnp.asarray, tree), model, params


@pytest.fixture(scope="module")
def jitted():
    """The reference's prefill and decode step, jitted once per max_len."""
    cache = {}

    def get(jmodel, max_len):
        if max_len not in cache:
            cache[max_len] = (
                jax.jit(lambda p, t: jmodel.prefill(p, {"tokens": t}, None,
                                                    max_len)),
                jax.jit(lambda p, s, t, q: jmodel.decode_step(p, s, t, q,
                                                              None)))
        return cache[max_len]
    return get


def test_config_and_layer_groups():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.vocab) == (34, 2560, 8, 4, 256, 262144)
    glob, loc = T.layer_groups(cfg)
    assert glob == [5, 11, 17, 23, 29] and len(loc) == 29
    assert T.layer_windows(cfg).count(1024) == 29
    assert T.layer_groups(smoke_config(ARCH)) == ([2], [0, 1])
    assert T.layer_groups(smoke_config("qwen3-1.7b")) == ([0, 1], [])


@pytest.mark.parametrize("B,Sk,window,pos", [(2, 8, 8, 5), (2, 8, 8, 20),
                                             (1, 6, 4, 9), (3, 8, 3, 7)])
def test_ring_attention_matches_reference(B, Sk, window, pos):
    """One query at ``pos`` over a ring of the last Sk positions (k_start =
    pos - Sk + 1: negative positions masked when pos < Sk - 1), windowed."""
    rng = np.random.default_rng(pos)
    q = rng.normal(size=(B, 1, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(B, Sk, 2, 16)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=True, window=window, q_offset=pos, k_start=pos - Sk + 1,
              kv_chunk=Sk)
    want = JA.gqa_attention(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    got = A.gqa_attention(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    _close(got, want, f"ring attention B={B} Sk={Sk} window={window} "
           f"pos={pos}")


def test_ring_attention_over_chunks_raises_as_the_reference():
    q = torch.zeros(1, 1, 2, 16)
    k = torch.zeros(1, 8, 2, 16)
    with pytest.raises(NotImplementedError, match="one chunk"):
        A.gqa_attention(q, k, k, q_offset=9, k_start=2, kv_chunk=4)


def _cache_close(cache, jcache, what):
    assert sorted(cache) == sorted(jcache) == ["k", "k_loc", "v", "v_loc"]
    for name in cache:
        _close(cache[name], jcache[name], f"{what} {name}")


@pytest.mark.parametrize("S", [5, 11])
def test_prefill_then_decode_across_the_ring_wrap(pair, jitted, S):
    """Prompts of S tokens (shorter and longer than W), prefill into a
    24-row cache, then W + 6 aligned decode steps: every step's logits and
    all four cache leaves against the reference's."""
    jmodel, jp, model, params = pair
    max_len = 24
    jprefill, jdecode = jitted(jmodel, max_len)
    rng = np.random.default_rng(S)
    toks = rng.integers(0, model.cfg.vocab, (2, S)).astype(np.int32)
    jc, jh = jprefill(jp, jnp.asarray(toks))
    cache, h = model.prefill(params, torch.from_numpy(toks), max_len)
    _close(h, jh, "prefill hidden")
    _cache_close(cache, jc, "prefill")
    assert cache["k_loc"].shape == (2, 2, W, 2, 16)
    if S < W:                          # left-padded with zeros
        assert not cache["k_loc"][:, :, :W - S].any()
    for step in range(W + 6):
        tok = rng.integers(0, model.cfg.vocab, (2, 1)).astype(np.int32)
        jc, jlog = jdecode(jp, jc, jnp.asarray(tok),
                           jnp.asarray(S + step, jnp.int32))
        log = model.decode_step(params, cache, torch.from_numpy(tok),
                                S + step)
        assert log.dtype == torch.float32
        _close(log, jlog, f"decode logits step {step}")
        _cache_close(cache, jc, f"decode step {step}")


def test_decode_matches_prefill(pair):
    """Teacher forcing past the ring's wrap: decoding token t from a cache
    built from tokens[:t] gives the logits of prefilling tokens[:t+1]."""
    _, _, model, params = pair
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab, (2, 14))
                            .astype(np.int32))
    cache, _ = model.prefill(params, toks[:, :6], 16)
    for t in range(6, 14):
        got = model.decode_step(params, cache, toks[:, t:t + 1], t)
        _, hidden = model.prefill(params, toks[:, :t + 1], 16)
        want = model.lm_head(params, hidden[:, -1:])
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _greedy(prefill, decode, lm_head, prompts, max_new):
    """Aligned greedy decode; the streams and each step's top-two gaps."""
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


@pytest.mark.parametrize("S", [4, 10])
def test_greedy_streams_match_reference(pair, jitted, S):
    """Three prompts of S tokens, 12 greedy tokens each (across the ring's
    wrap): the streams equal the reference's, unless a flip is traced to a
    near-tie of the reference's logits.  Prefill runs flash attention once
    a layer (its plain version here), decode never."""
    jmodel, jp, model, params = pair
    rng = np.random.default_rng(9 + S)
    prompts = rng.integers(0, model.cfg.vocab, (3, S)).astype(np.int32)
    max_len = S + 12
    jprefill, jdecode = jitted(jmodel, max_len)
    want, gaps = _greedy(
        lambda t: jprefill(jp, jnp.asarray(t)),
        lambda s, t, q: jdecode(jp, s, jnp.asarray(t),
                                jnp.asarray(q, jnp.int32)),
        lambda h: jmodel.lm_head(jp, h, None), prompts, 12)
    ops.reset_counts()
    got, _ = _greedy(
        lambda t: model.prefill(params, torch.from_numpy(t), max_len),
        lambda s, t, q: (s, model.decode_step(params, s, torch.from_numpy(t),
                                              q)),
        lambda h: model.lm_head(params, h), prompts, 12)
    n = model.cfg.n_layers
    assert ops.COUNTS["flash_attention"].plain == n
    # B2 a step: the first norm alone, every other norm with its add
    assert ops.COUNTS["rmsnorm_add"].plain == 2 * n * 12
    ops.reset_counts()
    for row, (g, w) in enumerate(zip(got, want)):
        first = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b),
                     None)
        if first is not None:
            assert gaps[first, row] < 1e-4, (
                f"row {row}: streams differ at token {first} where the "
                f"reference's top-two logit gap is {gaps[first, row]}")


# ---------------------------------------------------------------------------
# what the model refuses
# ---------------------------------------------------------------------------

def test_engines_and_launcher_refuse_window_caches(pair):
    _, _, model, params = pair
    assert isinstance(model, DecoderLM) and not model.supports_paged_decode()
    why = model.engine_refusal()
    assert "aligned batch" in why and "transformer.py:603" in why
    for arch in ("qwen2-7b", "qwen3-1.7b"):
        assert build_model(smoke_config(arch)).engine_refusal() is None
    msg = (r"gemma3-4b \(dense\) is not served by the engine.*aligned "
           r"batch.*window-cache decode is aligned-only")
    for kw in ({}, {"paged": False}):
        with pytest.raises(ValueError, match=msg):
            ServeEngine(model, params, device="cpu", **kw)
    with pytest.raises(ValueError, match=msg):
        DisaggServeEngine(model, params, device="cpu")
    from repro_torch.launch import serve as launch_serve
    with pytest.raises(SystemExit, match=r"gemma3-4b.*aligned batch"):
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])


def test_position_vector_raises_and_state_specs(pair):
    _, _, model, params = pair
    cache, _ = model.prefill(params, torch.tensor([[1, 2, 3], [4, 5, 6]]), 8)
    for pos in (torch.tensor([3, 3]), [3, 3], np.array([3, 3])):
        with pytest.raises(ValueError, match=r"one integer for the whole "
                           r"batch, got shape \(2,\).*aligned batch"):
            model.decode_step(params, cache, torch.tensor([[7], [8]]), pos)
    fresh = model.init_decode_state(2, 20, device="cpu")
    assert {k: tuple(v.shape) for k, v in fresh.items()} == {
        "k": (1, 2, 20, 2, 16), "v": (1, 2, 20, 2, 16),
        "k_loc": (2, 2, W, 2, 16), "v_loc": (2, 2, W, 2, 16)}
    assert not any(v.any() for v in fresh.values())
    short = model.init_decode_state(1, 5, device="cpu")   # W = max_len
    assert short["k_loc"].shape == (2, 1, 5, 2, 16)
    spec = (None, "model", None, None, None)
    assert model.serve_state_specs(2, 20) == {
        "k": spec, "v": spec, "k_loc": spec, "v_loc": spec}
