"""The port's seeded sampling against the reference's: the threefry keys
and draws of ``repro_torch.serve.prng`` against ``jax.random`` (integer
bits bit for bit), the sampling heads' tokens on seeded logits, the
rejection rule, and the engine's seeded and custom-sampler streams on the
paged and dense paths.

Integer draws (``bits``) and everything built on them without a
transcendental function (``split``, ``fold_in``, ``uniform``) are exact.
The Gumbel noise is ``-log(-log(u))`` of an exact ``u``; torch's and
XLA's float32 ``log`` differ by an ulp on some inputs, so the noise is
held within 1e-6 and the tokens drawn from it are held equal on the
seeded logits below, where no such ulp decides an argmax (a flip needs two
candidates within an ulp of each other).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.models.api import build_model as jax_build_model
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import sampling as JS
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import smoke_config
from repro_torch.models.api import build_model
from repro_torch.serve import prng
from repro_torch.serve import sampling as S
from repro_torch.serve.engine import ServeEngine

SEEDS = [0, 1, 7, 42, 2**31 - 1, -1]
SHAPES = [(), (1,), (7,), (3, 5), (2, 3, 4), (152064,)]
TINY = float(np.finfo(np.float32).tiny)


def _jkey(seed):
    return jax.random.PRNGKey(seed)


# ---------------------------------------------------------------------------
# keys and draws, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_keys_match_jax(seed):
    """PRNGKey, fold_in and split (2 and 5 ways) give jax's key words."""
    k, jk = prng.PRNGKey(seed), _jkey(seed)
    np.testing.assert_array_equal(k, np.asarray(jk))
    for d in (0, 1, 5, 2**31 + 3):
        np.testing.assert_array_equal(prng.fold_in(k, d),
                                      np.asarray(jax.random.fold_in(jk, d)))
    for n in (2, 5):
        np.testing.assert_array_equal(prng.split(k, n),
                                      np.asarray(jax.random.split(jk, n)))
    # a chain of splits and folds, as the engine walks its key
    for i in range(4):
        k, sub = prng.split(k)
        jk, jsub = jax.random.split(jk)
        np.testing.assert_array_equal(prng.fold_in(sub, i),
                                      np.asarray(jax.random.fold_in(jsub, i)))
    np.testing.assert_array_equal(k, np.asarray(jk))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", [3, 2**31 - 1])
def test_bits_and_uniform_match_jax(seed, shape):
    """bits (an odd size, several axes, the full qwen2 vocab of 152064) and
    uniform on [0, 1), [tiny, 1) and [-2, 3): exact."""
    k, jk = prng.PRNGKey(seed), _jkey(seed)
    want = np.asarray(jax.random.bits(jk, shape)).astype(np.int64)
    got = prng.bits(k, shape)
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)
    for lo, hi in ((0.0, 1.0), (TINY, 1.0), (-2.0, 3.0)):
        want = np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=hi))
        got = prng.uniform(k, shape, minval=lo, maxval=hi)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_gumbel_close_to_jax():
    """The Gumbel noise: an exact uniform through two float32 logs, which
    torch and XLA round apart by an ulp on some inputs.  The inner log's
    ulp (relative 1.2e-7) becomes an absolute error of the outer one, so
    the bound is absolute: 1e-6, twice the largest gap seen (4.8e-7)."""
    k, jk = prng.PRNGKey(5), _jkey(5)
    want = np.asarray(jax.random.gumbel(jk, (152064,)))
    got = prng.gumbel(k, (152064,)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got == want).mean() > 0.5


def test_gumbel_draws_on_the_keys_device():
    """With no ``device``, a tensor key's draw lands where the key lies
    (here the host, as ``bits``, ``uniform`` and ``normal`` place theirs),
    with the values of the draw named there."""
    k = prng.PRNGKey(7, device="cpu")
    got = prng.gumbel(k, (4, 33))
    assert got.device == k.device
    assert torch.equal(got, prng.gumbel(k, (4, 33), device="cpu"))
    assert torch.equal(got, prng.gumbel(prng.PRNGKey(7), (4, 33)))


@pytest.mark.parametrize("V", [3, 1000, 152064])
def test_categorical_matches_jax(V):
    rng = np.random.default_rng(V)
    for i in range(12):
        logits = (2 * rng.standard_normal((2, V))).astype(np.float32)
        want = np.asarray(jax.random.categorical(_jkey(i), logits))
        got = prng.categorical(prng.PRNGKey(i), torch.from_numpy(logits))
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# sampling heads: the reference's tokens on seeded logits
# ---------------------------------------------------------------------------

HEADS = {
    "top_k": (functools.partial(JS.sample_top_k, k=40, temperature=0.8),
              functools.partial(S.sample_top_k, k=40, temperature=0.8)),
    "top_p": (functools.partial(JS.sample_top_p, p=0.9, temperature=0.8),
              functools.partial(S.sample_top_p, p=0.9, temperature=0.8)),
    "temperature": (functools.partial(JS.sample_temperature, temperature=0.8),
                    functools.partial(S.sample_temperature, temperature=0.8)),
}


@pytest.mark.parametrize("head", list(HEADS))
@pytest.mark.parametrize("V,true_vocab", [(512, 500), (152064, None)])
def test_sampling_heads_match_reference(head, V, true_vocab):
    """One row and a (2, V) batch, the padded vocab tail masked."""
    jfn, fn = HEADS[head]
    rng = np.random.default_rng(V + len(head))
    for i in range(6):
        for shape in ((V,), (2, V)):
            logits = (3 * rng.standard_normal(shape)).astype(np.float32)
            want = np.asarray(jfn(_jkey(100 + i), jnp.asarray(logits),
                                  true_vocab=true_vocab))
            got = fn(prng.PRNGKey(100 + i), torch.from_numpy(logits),
                     true_vocab=true_vocab)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("head", list(HEADS))
def test_sampling_heads_greedy_at_zero_temperature(head):
    fn = HEADS[head][1]
    logits = torch.tensor([[0.0, 3.0, 1.0, 9.0]])
    out = fn.func(prng.PRNGKey(0), logits, temperature=0.0, true_vocab=3)
    assert out.tolist() == [1]


def test_top_k_breaks_ties_to_the_lower_index():
    """Tied logits come out of the top k in index order, as lax.top_k's."""
    logits = np.asarray([1.0, 5.0, 5.0, 0.0, 5.0, 2.0, 2.0], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(logits), 5)
    got_v, got_i = S._top_k(torch.from_numpy(logits), 5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    for i in range(20):     # draws among the tied top entries
        want = JS.sample_top_k(_jkey(i), jnp.asarray(logits), k=3)
        got = S.sample_top_k(prng.PRNGKey(i), torch.from_numpy(logits), k=3)
        assert int(got) == int(want)


# ---------------------------------------------------------------------------
# speculative rejection sampling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("true_vocab", [None, 60])
def test_spec_rejection_sample_matches_reference(true_vocab):
    """Accepted counts and emitted tokens on seeded (C, V) logits and
    drafts, at two temperatures, for drafts likely and unlikely."""
    rng = np.random.default_rng(9)
    for i in range(30):
        logits = (2 * rng.standard_normal((4, 64))).astype(np.float32)
        if i % 2:
            draft = [int(t) for t in logits[:3].argmax(-1)]
        else:
            draft = [int(t) for t in rng.integers(0, 60, 3)]
        temp = 0.7 if i % 3 else 1.3
        want = JS.spec_rejection_sample(
            [_jkey(1000 + 4 * i + j) for j in range(4)], logits, draft,
            temperature=temp, true_vocab=true_vocab)
        got = S.spec_rejection_sample(
            [prng.PRNGKey(1000 + 4 * i + j) for j in range(4)], logits,
            draft, temperature=temp, true_vocab=true_vocab)
        assert got == want


def test_spec_rejection_preserves_target_distribution():
    """The emitted first token's marginal equals softmax(logits) whatever
    the drafter proposed (an unlikely and a likely draft), as the
    reference's preservation test checks it, over the port's keys."""
    logits = np.log(np.asarray([[0.6, 0.3, 0.1]], np.float32))
    for draft_tok in (2, 0):
        draws = []
        for i in range(400):
            keys = [prng.PRNGKey(1000 * draft_tok + i),
                    prng.PRNGKey(987654 + i)]
            _, emitted = S.spec_rejection_sample(
                keys, np.tile(logits, (2, 1)), [draft_tok])
            draws.append(emitted[0])
        freq = np.bincount(np.asarray(draws), minlength=3) / len(draws)
        assert abs(freq[0] - 0.6) < 0.08, (draft_tok, freq)
        assert abs(freq[1] - 0.3) < 0.08, (draft_tok, freq)


def test_spec_verify_greedy_accepts_matching_prefix():
    rows = np.asarray([4, 5, 6, 7])
    assert S.spec_verify_greedy(rows, [4, 5, 6]) == (3, [4, 5, 6, 7])
    assert S.spec_verify_greedy(rows, [4, 9, 6]) == (1, [4, 5])
    assert S.spec_verify_greedy(rows, []) == (0, [4])


# ---------------------------------------------------------------------------
# the engine: seeded and custom-sampler streams against the reference's
# ---------------------------------------------------------------------------

PROMPTS = [[5, 17, 33, 2, 9], [100, 200, 300], [7] * 11, list(range(20))]


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


def _requests(lib, vocab):
    """Per-request sampling: seeded top-k, unseeded temperature (the engine
    key's fold), seeded top-p, and a seeded greedy request."""
    sam = JS if lib == "jax" else S
    return [dict(seed=3, sampler=functools.partial(
                sam.sample_top_k, k=8, temperature=0.8, true_vocab=vocab)),
            dict(sampler=functools.partial(
                sam.sample_temperature, temperature=0.8, true_vocab=vocab)),
            dict(seed=11, sampler=functools.partial(
                sam.sample_top_p, p=0.9, temperature=0.8, true_vocab=vocab)),
            dict(seed=5)]


def _serve(engine_cls, model, params, reqs, **kw):
    eng = engine_cls(model, params, max_slots=3, max_len=128, page_size=16,
                     prefill_chunk=16, **kw)
    for p, r in zip(PROMPTS, reqs):
        eng.submit(p, max_new_tokens=10, **r)
    done = eng.run_until_drained()
    eng.close()
    return {r.rid: ([int(t) for t in r.output], r.error is None)
            for r in done}


@pytest.mark.parametrize("paged", [True, False])
def test_per_request_samplers_match_reference(pair, paged):
    jmodel, jparams, model, params = pair
    v = model.cfg.vocab
    want = _serve(JaxServeEngine, jmodel, jparams, _requests("jax", v),
                  paged=paged)
    got = _serve(ServeEngine, model, params, _requests("torch", v),
                 paged=paged, device="cpu")
    assert got == want
    again = _serve(ServeEngine, model, params, _requests("torch", v),
                   paged=paged, device="cpu")
    assert again == got                     # seeded: reproduces


@pytest.mark.parametrize("paged", [True, False])
def test_engine_wide_sampler_matches_reference(pair, paged):
    """An engine-wide temperature sampler over the batch, two requests
    seeded (their rows redrawn with their own keys)."""
    jmodel, jparams, model, params = pair
    v = model.cfg.vocab
    reqs = [dict(seed=1), {}, dict(seed=2), {}]
    want = _serve(JaxServeEngine, jmodel, jparams, reqs, paged=paged,
                  sampler=functools.partial(JS.sample_temperature,
                                            temperature=0.9, true_vocab=v))
    got = _serve(ServeEngine, model, params, reqs, paged=paged, device="cpu",
                 sampler=functools.partial(S.sample_temperature,
                                           temperature=0.9, true_vocab=v))
    assert got == want


def test_constant_request_sampler_overrides_greedy(pair):
    """A request's own sampler draws its tokens while the rest of the batch
    keeps the engine's greedy default (the reference's test_serve.py
    override test), on the port's two paths."""
    _, _, model, params = pair
    want = _serve(ServeEngine, model, params, [{}, {}], device="cpu")
    const = lambda key, logits: torch.tensor(7, dtype=torch.int32)  # noqa
    for paged in (True, False):
        got = _serve(ServeEngine, model, params,
                     [dict(sampler=const), {}], paged=paged, device="cpu")
        assert got[0] == ([7] * 10, True)
        assert got[1] == want[1]


def test_failing_request_sampler_is_isolated(pair):
    """A per-request sampler that raises retires its request with the
    error; the others finish with their greedy streams."""
    _, _, model, params = pair
    want = _serve(ServeEngine, model, params, [{}, {}, {}], device="cpu")
    calls = []

    def flaky(key, logits):
        calls.append(1)
        if len(calls) == 3:
            raise ValueError("injected sampler failure")
        return S.greedy(logits)

    eng = ServeEngine(model, params, max_slots=3, max_len=128, page_size=16,
                      prefill_chunk=16, device="cpu")
    for i, p in enumerate(PROMPTS[:3]):
        eng.submit(p, max_new_tokens=10, sampler=flaky if i == 1 else None)
    by_rid = {r.rid: r for r in eng.run_until_drained()}
    assert isinstance(by_rid[1].error, ValueError)
    assert by_rid[0].output == want[0][0] and by_rid[2].output == want[2][0]
    assert eng.pool.pages_in_use == 0
