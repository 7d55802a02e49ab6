"""The port's whisper (enc-dec audio) serving against the reference's, on
the SMOKE config in float32 with bridged weights: the encoder (whole clip
and streaming chunks, B3's keys-cut route for a chunk's right-pad), the
cross K/V and their scatter (float and int8 pages), the three paged calls
call by call (logits and every storage leaf), the dense prefill and
decode step, the cross read's dead-slot zeros, the engine's greedy streams
(one clip, batched requests and release, a short clip, int8 KV, ngram
speculation, forced preemption with the cross pool conserved), the
refusals with the reference's messages, a virtual-clock traffic run with
the audio band, and the launcher's ``--audio``."""
import json
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.launch import serve as jax_launch  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import whisper as JW  # noqa: E402
from repro.models.api import build_model as jax_build_model  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve import quant as JQ  # noqa: E402
from repro.serve import traffic as JT  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import whisper as W  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.serve import pages as PG  # noqa: E402
from repro_torch.serve import quant as QZ  # noqa: E402
from repro_torch.serve import traffic as T  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

# float32 on both sides, only the summation order differs: <= 1e-5 of the
# largest magnitude a call produces (int8 pages: a code one step apart
# may move a later layer by one quantization step)
REL = 1e-5
INT8_REL = 1e-3
# the dense prefill chains the whole encoder into the decoder (4 blocks, 5
# LayerNorms, the cross read): there the reference's own float32 result
# lies 1.8e-5 (relative) from a float64 evaluation of the same function,
# the port's 8e-6
DENSE_REL = 3e-5
PS, N_PAGES, N_CROSS = 8, 12, 6
ENGINE_KW = dict(max_slots=2, max_len=64, page_size=8, prefill_chunk=16)


@pytest.fixture(scope="module")
def pair():
    """(reference model, its params, port model, bridged params)."""
    jmodel = jax_build_model(
        jax_smoke_config("whisper-tiny").replace(remat="none"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(smoke_config("whisper-tiny"))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu", defs=model.param_defs())
    return jmodel, jparams, model, params


def _close(got, want, rel=REL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= rel, f"{what}: relative error {err} > {rel}"


def _frames(cfg, n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# layers, encoder, cross K/V, scatter
# ---------------------------------------------------------------------------

def test_layers_match_reference():
    """``sinusoidal_pos`` (odd and even widths, positions to 1500),
    ``mlp_plain`` (jax's tanh GELU, not torch's erf default), the tied
    ``unembed`` and ``embedding_def``'s shape."""
    from repro.models import layers as JL
    from repro_torch.models import layers as L
    rng = np.random.default_rng(12)
    pos = np.array([0, 1, 7, 63, 1499], np.int32)
    # torch's float32 pow and XLA's part by an ulp in 1-2 of the 192
    # frequencies (both as close to float64's); at position 1499 an ulp of
    # a frequency moves its angle by ~1e-4
    for dim in (16, 64, 384):
        _close(L.sinusoidal_pos(torch.from_numpy(pos), dim),
               JL.sinusoidal_pos(jnp.asarray(pos), dim), 2e-4, "sinusoid")
    p = {k: rng.standard_normal(sh).astype(np.float32) for k, sh in
         (("up", (16, 32)), ("up_b", (32,)), ("down", (32, 16)),
          ("down_b", (16,)))}
    x = rng.standard_normal((2, 3, 16)).astype(np.float32) * 3
    _close(L.mlp_plain({k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x)),
           JL.mlp_plain({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x)), what="mlp_plain")
    table = rng.standard_normal((10, 16)).astype(np.float32)
    _close(L.unembed({"table": torch.from_numpy(table)},
                     torch.from_numpy(x)),
           JL.unembed({"table": jnp.asarray(table)}, jnp.asarray(x)),
           what="unembed")
    assert L.embedding_def(10, 16)["table"].shape == \
        JL.embedding_def(10, 16)["table"].shape

def test_encode_whole_clip_matches_reference(pair):
    jm, jp, model, params = pair
    cfg = model.cfg
    fr = np.stack([_frames(cfg, cfg.n_audio_frames, s) for s in (0, 1)])
    want = JW.encode(jp, jm.cfg, None, jnp.asarray(fr))
    ops.reset_counts()
    got = W.encode(params, cfg, torch.from_numpy(fr))
    _close(got, want, what="encode")
    # every encoder layer's attention is one B3 call (plain on the CPU)
    assert ops.COUNTS["flash_attention"].plain == cfg.n_layers


@pytest.mark.parametrize("start,n_valid", [(0, 16), (0, 5), (16, 1)])
def test_encode_chunk_keys_cut_matches_reference(pair, start, n_valid):
    """A chunk right-padded past ``n_valid``: the port cuts K/V to their
    first n_valid rows (B3 at Sq 16, Sk n_valid) where the reference masks
    the keys; every row, the pad rows too, agrees."""
    jm, jp, model, params = pair
    fr = np.zeros((16, model.cfg.d_model), np.float32)
    fr[:n_valid] = _frames(model.cfg, n_valid, 3)
    want = jm.encode_chunk(jp, jnp.asarray(fr[None]), start, n_valid, None)
    ops.reset_counts()
    got = model.encode_chunk(params, torch.from_numpy(fr[None]), start,
                             n_valid)
    _close(got, want, what=f"encode_chunk start={start} n_valid={n_valid}")
    assert ops.COUNTS["flash_attention"].plain == model.cfg.n_layers


def _cross_storage(model, quant):
    specs = model.cross_leaf_specs(quant)
    return {k: torch.zeros(s.storage_shape(N_CROSS + 1, PS), dtype=s.dtype)
            for k, s in specs.items()}


@pytest.mark.parametrize("kv", ["off", "int8"])
def test_cross_kv_and_scatter_match_reference(pair, kv):
    jm, jp, model, params = pair
    fr = _frames(model.cfg, 16, 4)
    enc = model.encode_chunk(params, torch.from_numpy(fr[None]), 0, 16)
    jenc = jm.encode_chunk(jp, jnp.asarray(fr[None]), 0, 16, None)
    k, v = model.cross_kv_chunk(params, enc)
    jk, jv = jm.cross_kv_chunk(jp, jenc)
    _close(k, jk, what="cross k")
    _close(v, jv, what="cross v")
    pages = np.array([4, 1], np.int32)
    quant = QZ.make_kv_quant(None if kv == "off" else kv)
    jquant = JQ.make_kv_quant(None if kv == "off" else kv)
    st = _cross_storage(model, quant)
    jst = {n: jnp.zeros(t.shape, jnp.int8 if t.dtype == torch.int8
                        else jnp.float32) for n, t in st.items()}
    # the same K/V into both scatters: the storages must then be equal
    model.scatter_cross(st, torch.from_numpy(pages), k, v, page_size=PS,
                        quant=quant)
    jst = jm.scatter_cross(jst, jnp.asarray(pages), jnp.asarray(k.numpy()),
                           jnp.asarray(v.numpy()), page_size=PS, quant=jquant)
    assert set(st) == set(jst)
    for name in st:
        np.testing.assert_array_equal(st[name].numpy(), np.asarray(jst[name]),
                                      err_msg=name)


# ---------------------------------------------------------------------------
# the paged calls and the cross read
# ---------------------------------------------------------------------------

def _encoded(model, params, quant, frames):
    """Cross storage holding ``frames`` (one chunk) in pages [2, 5]."""
    st = _cross_storage(model, quant)
    pad = np.zeros((16, model.cfg.d_model), np.float32)
    pad[:len(frames)] = frames
    enc = model.encode_chunk(params, torch.from_numpy(pad[None]), 0,
                             len(frames))
    k, v = model.cross_kv_chunk(params, enc)
    model.scatter_cross(st, torch.tensor([2, 5]), k, v, page_size=PS,
                        quant=quant)
    return st


def _self_storage(model, quant):
    return {k: torch.zeros(s.storage_shape(N_PAGES + 1, PS), dtype=s.dtype)
            for k, s in model.paged_leaf_specs(quant).items()}


def _to_jax(tree):
    return {k: jnp.asarray(v.numpy()) for k, v in tree.items()}


@pytest.mark.parametrize("kv", ["off", "int8"])
def test_paged_calls_match_reference(pair, kv):
    """A 16-token prompt chunk, then a decode step and a verify window of 3
    over two slots (slot 1 dead: trash pages, frames_len 0): hidden states,
    live logits and every self-storage leaf against the reference's calls
    on the same storages."""
    jm, jp, model, params = pair
    cfg = model.cfg
    quant = QZ.make_kv_quant(None if kv == "off" else kv)
    jquant = JQ.make_kv_quant(None if kv == "off" else kv)
    rel = REL if kv == "off" else INT8_REL
    cst = _encoded(model, params, quant, _frames(cfg, 13, 5))
    jcst = _to_jax(cst)
    st = _self_storage(model, quant)
    jst = _to_jax(st)
    row = np.array([7, 3, 9, 0, 0, 0, 0, 0], np.int32)
    crow = np.array([2, 5], np.int32)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (1, 16))
    h, _ = model.paged_prefill_chunk(
        params, st, torch.from_numpy(row), torch.from_numpy(row[:2]), 0,
        torch.from_numpy(toks.astype(np.int32)), quant=quant,
        cross={"storage": cst, "tables": torch.from_numpy(crow),
               "frames_len": torch.tensor(13)})
    jst, jh, _ = jm.paged_prefill_chunk(
        jp, jst, jnp.asarray(row), jnp.asarray(row[:2]), 0,
        jnp.asarray(toks, jnp.int32), None, quant=jquant,
        cross=dict(storage=jcst, tables=jnp.asarray(crow),
                   frames_len=jnp.int32(13)))
    _close(h, jh, rel, "prefill chunk hidden")
    trash = N_PAGES
    tables = np.stack([row, np.full(8, trash, np.int32)])
    ctables = np.stack([crow, np.zeros(2, np.int32)])  # stale row, as freed
    flen = np.array([13, 0], np.int32)
    for C in (1, 3):
        lens = np.array([16, 0], np.int32)
        t = np.random.default_rng(C).integers(0, cfg.vocab, (2, C)).astype(
            np.int32)
        wp = np.full((2, C), trash, np.int32)
        wo = np.zeros((2, C), np.int32)
        wp[0] = row[(16 + np.arange(C)) // PS]
        wo[0] = (16 + np.arange(C)) % PS
        cross = {"storage": cst, "tables": torch.from_numpy(ctables),
                 "frames_len": torch.from_numpy(flen)}
        jcross = dict(storage=jcst, tables=jnp.asarray(ctables),
                      frames_len=jnp.asarray(flen))
        if C == 1:
            lg, _ = model.paged_decode_step(
                params, st, torch.from_numpy(tables), torch.from_numpy(lens),
                torch.from_numpy(t), torch.from_numpy(wp[:, 0]),
                torch.from_numpy(wo[:, 0]), quant=quant, cross=cross)
            jst, jlg, _ = jm.paged_decode_step(
                jp, jst, jnp.asarray(tables), jnp.asarray(lens),
                jnp.asarray(t), jnp.asarray(wp[:, 0]), jnp.asarray(wo[:, 0]),
                None, quant=jquant, cross=jcross)
        else:
            lens[0] = 17
            wp[0] = row[(17 + np.arange(C)) // PS]
            wo[0] = (17 + np.arange(C)) % PS
            lg, _ = model.paged_verify(
                params, st, torch.from_numpy(tables), torch.from_numpy(lens),
                torch.from_numpy(t), torch.from_numpy(wp),
                torch.from_numpy(wo), quant=quant, cross=cross)
            jst, jlg, _ = jm.paged_verify(
                jp, jst, jnp.asarray(tables), jnp.asarray(lens),
                jnp.asarray(t), jnp.asarray(wp), jnp.asarray(wo), None,
                quant=jquant, cross=jcross)
        _close(lg[0], np.asarray(jlg)[0], rel, f"logits C={C}")
    for name in st:
        got = st[name][:, :N_PAGES]
        want = np.asarray(jst[name])[:, :N_PAGES]
        if got.dtype == torch.int8:      # codes one step apart at most
            assert np.abs(got.numpy().astype(int) - want).max() <= 1, name
        else:
            _close(got, want, rel, name)


def test_dead_slot_cross_read_is_zero(pair):
    """A slot at frames_len 0 reads exactly zeros (no NaN), whatever its
    table points at; the live slot's read equals the reference's masked
    softmax.  The reference's own dead-slot read averages the values its
    table points at (its -1e30 mask bias cancels in ``s - max``)."""
    _, _, model, _ = pair
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 16, 4, 16)).astype(np.float32)
    v = rng.standard_normal((2, 16, 4, 16)).astype(np.float32)
    flen = np.array([11, 0], np.int32)
    got = W.cross_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(flen))
    want = JA.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=False, kv_valid_len=jnp.asarray(flen),
                            kv_chunk=16)
    assert torch.isfinite(got).all()
    assert torch.equal(got[1], torch.zeros_like(got[1]))
    _close(got[0], np.asarray(want)[0], what="live slot")
    np.testing.assert_allclose(np.asarray(want)[1, 0],
                               np.broadcast_to(v[1].mean(0),
                                               (4, 16)), rtol=1e-5,
                               atol=1e-6)


def test_dense_prefill_and_decode_match_reference(pair):
    jm, jp, model, params = pair
    cfg = model.cfg
    fr = _frames(cfg, cfg.n_audio_frames, 9)[None]
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (1, 7)).astype(
        np.int32)
    state, h = model.prefill(params, {"frames": torch.from_numpy(fr),
                                      "tokens": torch.from_numpy(toks)}, 12)
    # jitted: the reference's eager dispatch takes 7 s here
    jstate, jh = jax.jit(lambda p, b: jm.prefill(p, b, None, 12))(
        jp, {"frames": jnp.asarray(fr), "tokens": jnp.asarray(toks)})
    _close(h, jh, DENSE_REL, "prefill hidden")
    for name in state:
        _close(state[name], jstate[name], DENSE_REL, name)
    tok = np.array([[3]], np.int32)
    lg = model.decode_step(params, state, torch.from_numpy(tok), 7)
    jstate, jlg = jax.jit(lambda p, st, t: jm.decode_step(
        p, st, t, jnp.int32(7), None))(jp, jstate, jnp.asarray(tok))
    _close(lg, jlg, DENSE_REL, "decode logits")
    _close(state["self_k"], jstate["self_k"], DENSE_REL, "self_k after decode")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _serve(engine_cls, model, params, reqs, *, check=None, **kw):
    eng = engine_cls(model, params, **dict(ENGINE_KW, **kw))
    for prompt, frames, n in reqs:
        eng.submit(prompt, max_new_tokens=n, encoder_input=frames)
    for _ in range(400):
        busy = eng.tick()
        if check is not None:
            check(eng)
        if not busy and not eng.sched.has_work():
            break
    eng.close()
    assert all(r.error is None for r in eng.finished)
    return {r.rid: r.output for r in eng.finished}, dict(eng.stats), eng


def _cross_whole(eng):
    cp = eng.cross_pool
    assert cp.pages_free + cp.pages_in_use == cp.num_pages
    assert cp.pages_cached == 0
    assert cp.pages_in_use == eng.sched.held_cross_pages()


def _both(pair, reqs, **kw):
    jm, jp, model, params = pair
    want, ws, _ = _serve(JaxServeEngine, jm, jp, reqs, **kw)
    got, gs, eng = _serve(ServeEngine, model, params, reqs, device="cpu",
                          check=_cross_whole, **kw)
    assert got == want
    for k in ("ticks", "chunk_prefills", "encode_chunks", "preemptions",
              "draft_proposed", "draft_accepted"):
        assert gs[k] == ws[k], k
    assert eng.cross_pool.pages_in_use == 0
    return got, gs


def _reqs(cfg, seed, specs):
    rng = np.random.default_rng(seed)
    clips = [_frames(cfg, n, seed + i) for i, n in
             enumerate(sorted({n for _, n, _ in specs}))]
    by_n = dict(zip(sorted({n for _, n, _ in specs}), clips))
    return [(rng.integers(0, cfg.vocab, plen).astype(np.int32), by_n[n], new)
            for plen, n, new in specs]


def test_single_clip_stream_matches_reference_and_dense(pair):
    """One clip that fits one encode chunk: the paged stream equals the
    reference engine's and the dense prefill + decode loop's."""
    jm, jp, model, params = pair
    cfg = model.cfg
    reqs = _reqs(cfg, 0, [(9, cfg.n_audio_frames, 6)])
    got, stats = _both(pair, reqs)
    prompt, frames, n = reqs[0]
    state, h = model.prefill(params, {
        "frames": torch.from_numpy(frames[None]),
        "tokens": torch.from_numpy(prompt[None])}, len(prompt) + n + 2)
    out = [int(model.lm_head(params, h[:, -1:])[0, -1, :cfg.vocab].argmax())]
    for t in range(n - 1):
        lg = model.decode_step(params, state, torch.tensor([[out[-1]]]),
                               len(prompt) + t)
        out.append(int(lg[0, -1, :cfg.vocab].argmax()))
    assert got[0] == out
    assert stats["encode_chunks"] == 1


@pytest.mark.parametrize("case", ["batched", "short", "int8", "ngram",
                                  "preempt"])
def test_streams_match_reference(pair, case):
    """Batched requests on two clips (identical pairs equal), a 5-frame
    clip, int8 KV (cross pages included), ngram speculation (drafts
    proposed and verified through the cross bundle) and forced preemption
    (a pool of 5 pages for three 10-token prompts): streams and counters
    equal the reference engine's; the cross pool whole after every tick
    and empty at the end."""
    cfg = pair[2].cfg
    F = cfg.n_audio_frames
    if case == "batched":
        reqs = _reqs(cfg, 1, [(6, F, 5), (9, F - 1, 5)])
        reqs.append(reqs[0])
        got, _ = _both(pair, reqs, max_slots=3)
        assert got[0] == got[2]
    elif case == "short":
        _both(pair, _reqs(cfg, 2, [(6, 5, 4)]))
    elif case == "int8":
        _both(pair, _reqs(cfg, 7, [(8, F, 5), (5, 9, 5)]), kv_quant="int8")
    elif case == "ngram":
        clip = _frames(cfg, F, 11)
        reqs = [(np.array(p, np.int32), clip, 10) for p in
                ([5, 17, 33, 5, 17, 33, 5, 17], [7] * 11)]
        _, stats = _both(pair, reqs, max_len=128, spec_decode="ngram")
        assert stats["draft_proposed"] > 0
    else:
        _, stats = _both(pair, _reqs(cfg, 5, [(10, F, 12)] * 3),
                         max_slots=3, max_len=32, num_pages=5)
        assert stats["preemptions"] > 0


def test_cross_pool_refuses_prefix_cache():
    from repro.serve.pages import CrossKVPool as JCross
    from repro.serve.pages import PagedLeafSpec as JLeaf
    leaf = PG.PagedLeafSpec((1,), (1, 1), torch.float32)
    with pytest.raises(ValueError) as got:
        PG.CrossKVPool({"cross_k": leaf}, num_pages=4, page_size=4,
                       device="cpu", prefix_cache=True)
    with pytest.raises(ValueError) as want:
        JCross({"cross_k": JLeaf((1,), (1, 1), jnp.float32)}, num_pages=4,
               page_size=4, prefix_cache=True)
    assert str(got.value) == str(want.value)
    pool = PG.CrossKVPool({"cross_k": leaf}, num_pages=4, page_size=4,
                          device="cpu")
    assert pool.storage["cross_k"].shape[1] == 5       # the trash page


def _raises_same(port, ref, exc=ValueError):
    with pytest.raises(exc) as got:
        port()
    with pytest.raises(exc) as want:
        ref()
    assert str(got.value) == str(want.value)
    return str(got.value)


@pytest.mark.parametrize("case", ["dense", "prefill_only", "no_clip",
                                  "too_long", "width", "mesh"])
def test_refusals_match_reference(pair, case):
    jm, jp, model, params = pair
    cfg = model.cfg
    prompt = np.arange(4, dtype=np.int32)
    if case in ("dense", "prefill_only"):
        kw = {"paged": False} if case == "dense" else {"prefill_only": True}
        _raises_same(lambda: ServeEngine(model, params, device="cpu",
                                         **dict(ENGINE_KW, **kw)),
                     lambda: JaxServeEngine(jm, jp, **dict(ENGINE_KW, **kw)))
        return
    if case == "mesh":
        msg = _raises_same(lambda: model.validate_serve_mesh(tp=2),
                           lambda: jm.validate_serve_mesh(tp=2))
        assert "drop --mesh" in msg
        return
    enc = {"no_clip": None,
           "too_long": np.zeros((cfg.n_audio_frames + 1, cfg.d_model)),
           "width": np.zeros((4, cfg.d_model + 1))}[case]
    eng = ServeEngine(model, params, device="cpu", **ENGINE_KW)
    jeng = JaxServeEngine(jm, jp, **ENGINE_KW)
    _raises_same(lambda: eng.submit(prompt, encoder_input=enc),
                 lambda: jeng.submit(prompt, encoder_input=enc))
    assert eng.prefix_cache is False
    eng.close()
    jeng.close()


def test_traffic_audio_band_matches_reference(pair):
    """A bursty workload whose every request carries one of two clips:
    the port's event log, streams and report under the virtual clock are
    the reference's."""
    jm, jp, model, params = pair
    cfg = model.cfg
    kw = dict(kind="bursty", n_requests=6, rate=1.0, vocab=cfg.vocab, seed=9,
              max_new_tokens=4, shared_prefix_len=0, n_sessions=0,
              len_mix=((1.0, 4, 10),), encoder="audio",
              encoder_shape=(cfg.n_audio_frames, cfg.d_model),
              encoder_frac=1.0, n_encoder_inputs=2)
    wl, jwl = T.make_workload(**kw), JT.make_workload(**kw)
    for a, b in zip(wl, jwl):
        np.testing.assert_array_equal(a.encoder_input, b.encoder_input)
    eng = ServeEngine(model, params, device="cpu", max_slots=3, max_len=64,
                      page_size=8, prefill_chunk=16)
    got = T.run_traffic(eng, wl)
    eng.close()
    jeng = JaxServeEngine(jm, jp, max_slots=3, max_len=64, page_size=8,
                          prefill_chunk=16)
    want = JT.run_traffic(jeng, jwl)
    jeng.close()
    assert got["events"] == want["events"]
    assert got["outputs"] == want["outputs"]
    assert got["report"] == want["report"]
    assert all(e.get("encoder_len") == cfg.n_audio_frames
               for e in got["events"] if e["kind"] == "submit")


_TIMES = re.compile(r" in [0-9.]+s \([0-9.]+ tok/s\)| mean TTFT \d+ms")


def _summary(out: str) -> list:
    return [_TIMES.sub("", ln) for ln in out.splitlines()
            if ln.startswith("[serve]") and "kernels:" not in ln
            and "kv_bytes_per_token" not in ln]


def test_launcher_audio_matches_reference(tmp_path, monkeypatch, capsys):
    """``--arch whisper-tiny --smoke --audio``: the closed-loop summary
    (times aside) and a virtual-clock traffic report equal the reference
    launcher's; the refusals of the multimodal flags are its too."""
    argv = ["--arch", "whisper-tiny", "--smoke", "--audio", "--requests",
            "4", "--max-new", "4", "--max-len", "64", "--shared-prefix", "8"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jax_launch.main()
    want = _summary(capsys.readouterr().out)
    launch.main(argv + ["--device", "cpu"])
    got = _summary(capsys.readouterr().out)
    assert got == want
    assert any("cross-KV: encode_chunks=4 pages_in_use=0/" in ln
               for ln in got)
    traffic = argv + ["--traffic", "poisson", "--rate", "0.5", "--clock",
                      "virtual"]
    monkeypatch.setattr(sys, "argv", ["serve"] + traffic + [
        "--metrics-out", str(tmp_path / "ref.json")])
    jax_launch.main()
    launch.main(traffic + ["--device", "cpu", "--metrics-out",
                           str(tmp_path / "port.json")])
    capsys.readouterr()
    assert json.loads((tmp_path / "port.json").read_text())["report"] \
        == json.loads((tmp_path / "ref.json").read_text())["report"]
    for bad in (["--arch", "qwen2-7b", "--smoke", "--audio"],
                ["--arch", "whisper-tiny", "--smoke", "--image"],
                ["--arch", "whisper-tiny", "--smoke", "--audio", "--dense"]):
        monkeypatch.setattr(sys, "argv", ["serve"] + bad)
        with pytest.raises(SystemExit) as want_exit:
            jax_launch.main()
        with pytest.raises(SystemExit) as got_exit:
            launch.main(bad + ["--device", "cpu"])
        assert str(got_exit.value) == str(want_exit.value)
