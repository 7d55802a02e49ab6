"""The port's VLM (llava) serving against the reference's, on the SMOKE
config in float32 with bridged weights: a prefill chunk over an image
prefix call by call (``embeds=``: hidden states and every storage leaf;
the embeds-free call unchanged), the dense prefill with image
embeddings, ``encoder_prefix_tokens`` bit for bit, the engine's greedy
streams (image requests against the dense reference loop, mixed image and
text requests, a repeated image with the reference's exact prefix hits,
int8 KV, Megatron TP 2 over gloo), the refusals with the reference's
messages, a virtual-clock traffic run with the image band, and the
launcher's ``--image``."""
import json
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_ranks as R  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.launch import serve as jax_launch  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.api import build_model as jax_build_model  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve import traffic as JTR  # noqa: E402
from repro.serve.engine import encoder_prefix_tokens as \
    jax_prefix_tokens  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import comm as C  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.serve import traffic as TR  # noqa: E402
from repro_torch.serve.engine import (ServeEngine,  # noqa: E402
                                      encoder_prefix_tokens)

# float32 on both sides, only the summation order differs: <= 1e-5 of the
# largest magnitude a call produces
REL = 1e-5
# the dense prefill of 15 rows through both layers: there the reference's
# own float32 hidden states lie 1.5e-5 (relative) from a float64
# evaluation of the same function, the port's 3e-6
DENSE_REL = 3e-5
PS, N_PAGES = 8, 10
ENGINE_KW = dict(max_slots=2, max_len=64, page_size=8, prefill_chunk=8)


@pytest.fixture(scope="module")
def pair():
    """(reference model, its params, port model, bridged params)."""
    jmodel = jax_build_model(
        jax_smoke_config("llava-next-mistral-7b").replace(remat="none"))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(smoke_config("llava-next-mistral-7b"))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams),
                               device="cpu")
    return jmodel, jparams, model, params


def _close(got, want, rel=REL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max()) / scale
    assert err <= rel, f"{what}: relative error {err} > {rel}"


def _image(cfg, seed):
    return np.random.default_rng(seed).standard_normal(
        (cfg.n_image_tokens, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# the model calls
# ---------------------------------------------------------------------------

def test_prefill_chunk_with_embeds_matches_reference(pair):
    """A 16-row chunk: 8 image rows (pseudo-tokens down to -2**31, which
    must never index the table) and 8 text tokens, then a text-only chunk
    after it: hidden states and the K/V pages against the reference's."""
    jm, jp, model, params = pair
    cfg = model.cfg
    img = _image(cfg, 0)
    pseudo = encoder_prefix_tokens(img)
    pseudo[0] = -2**31
    text = np.random.default_rng(1).integers(0, cfg.vocab, 24).astype(
        np.int32)
    toks = np.concatenate([pseudo, text[:8]])[None]
    emb = np.zeros((1, 16, cfg.d_model), np.float32)
    emb[0, :8] = img
    specs = model.paged_leaf_specs()
    st = {k: torch.zeros(s.storage_shape(N_PAGES + 1, PS), dtype=s.dtype)
          for k, s in specs.items()}
    jst = {k: jnp.zeros(t.shape, jnp.float32) for k, t in st.items()}
    row = np.array([3, 6, 1, 0, 0, 0, 0, 0], np.int32)
    h, _ = model.paged_prefill_chunk(
        params, st, torch.from_numpy(row), torch.from_numpy(row[:2]), 0,
        torch.from_numpy(toks), embeds=torch.from_numpy(emb))
    jst, jh, _ = JT.paged_prefill_chunk(
        jp, jm.cfg, None, jst, jnp.asarray(row), jnp.asarray(row[:2]), 0,
        jnp.asarray(toks), embeds=jnp.asarray(emb))
    _close(h, jh, what="image chunk hidden")
    rest = text[8:][None]
    h2, _ = model.paged_prefill_chunk(
        params, st, torch.from_numpy(row), torch.from_numpy(row[2:3]), 16,
        torch.from_numpy(rest[:, :8]))
    jst, jh2, _ = JT.paged_prefill_chunk(
        jp, jm.cfg, None, jst, jnp.asarray(row), jnp.asarray(row[2:3]), 16,
        jnp.asarray(rest[:, :8]))
    _close(h2, jh2, what="text chunk after the image")
    for name in st:
        _close(st[name][:, :N_PAGES], np.asarray(jst[name])[:, :N_PAGES],
               what=name)


def test_embeds_none_is_the_text_call(pair):
    """``embeds=None`` is the text-only call, bit for bit."""
    _, _, model, params = pair
    toks = torch.arange(8, dtype=torch.int32)[None]
    row = torch.tensor([2, 0, 0, 0], dtype=torch.int32)
    outs = []
    for kw in ({}, {"embeds": None}):
        st = {k: torch.zeros(s.storage_shape(4, PS), dtype=s.dtype)
              for k, s in model.paged_leaf_specs().items()}
        h, _ = model.paged_prefill_chunk(params, st, row, row[:1], 0, toks,
                                         **kw)
        outs.append((h, st))
    assert torch.equal(outs[0][0], outs[1][0])
    for name in outs[0][1]:
        assert torch.equal(outs[0][1][name], outs[1][1][name])


def test_dense_prefill_with_image_matches_reference(pair):
    jm, jp, model, params = pair
    cfg = model.cfg
    img = _image(cfg, 2)[None]
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (1, 7)).astype(
        np.int32)
    cache, h = model.prefill(params, {"tokens": torch.from_numpy(toks),
                                      "image_embeds": torch.from_numpy(img)},
                             24)
    jcache, jh = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                                 "image_embeds": jnp.asarray(img)}, None, 24)
    _close(h, jh, DENSE_REL, "hidden")
    for name in cache:
        _close(cache[name], jcache[name], DENSE_REL, name)


def test_encoder_prefix_tokens_bit_equal():
    """Random payloads of several shapes, a copy, and one changed bit."""
    rng = np.random.default_rng(3)
    for shape in ((8, 16), (8, 64), (2880, 4)):
        a = rng.standard_normal(shape).astype(np.float32)
        got = encoder_prefix_tokens(a)
        np.testing.assert_array_equal(got, jax_prefix_tokens(a))
        assert got.dtype == np.int32 and (got < 0).all()
        np.testing.assert_array_equal(got, encoder_prefix_tokens(a.copy()))
        b = a.copy()
        b.view(np.uint32)[0, 0] ^= 1
        assert not np.array_equal(got, encoder_prefix_tokens(b))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _serve(engine_cls, model, params, reqs, waves=False, **kw):
    eng = engine_cls(model, params, **dict(ENGINE_KW, **kw))
    for prompt, img, n in reqs:
        extra = {} if img is None else {"encoder_input": img}
        eng.submit(prompt, max_new_tokens=n, **extra)
        if waves:
            eng.run_until_drained()
    eng.run_until_drained()
    eng.close()
    assert all(r.error is None for r in eng.finished)
    if eng.pool is not None:
        pool = eng.pool
        assert pool.pages_free + pool.pages_cached + pool.pages_in_use \
            == pool.num_pages
    return {r.rid: r.output for r in eng.finished}, dict(eng.stats)


def _both(pair, reqs, waves=False, **kw):
    jm, jp, model, params = pair
    want, ws = _serve(JaxServeEngine, jm, jp, reqs, waves, **kw)
    got, gs = _serve(ServeEngine, model, params, reqs, waves, device="cpu",
                     **kw)
    assert got == want
    for k in ("ticks", "chunk_prefills", "prefix_hits", "prefix_hit_tokens",
              "pages_high_water", "preemptions"):
        assert gs[k] == ws[k], k
    return got, gs


def _reqs(cfg, seed):
    rng = np.random.default_rng(seed)
    img_a, img_b = _image(cfg, seed), _image(cfg, seed + 1)
    prompt = rng.integers(0, cfg.vocab, 9).astype(np.int32)
    text = rng.integers(0, cfg.vocab, 11).astype(np.int32)
    return img_a, img_b, prompt, text


def test_image_stream_matches_dense_reference_loop(pair):
    """One image request: the paged stream equals the reference engine's
    and the dense prefill-with-image + decode loop's."""
    _, _, model, params = pair
    cfg = model.cfg
    img, _, prompt, _ = _reqs(cfg, 0)
    got, _ = _both(pair, [(prompt, img, 6)])
    I, S = cfg.n_image_tokens, len(prompt)
    cache, h = model.prefill(params, {
        "tokens": torch.from_numpy(prompt[None]),
        "image_embeds": torch.from_numpy(img[None])}, I + S + 8)
    out = [int(model.lm_head(params, h[:, -1:])[0, -1, :cfg.vocab].argmax())]
    for t in range(5):
        lg = model.decode_step(params, cache, torch.tensor([[out[-1]]]),
                               I + S + t)
        out.append(int(lg[0, -1, :cfg.vocab].argmax()))
    assert got[0] == out


@pytest.mark.parametrize("case", ["mixed", "repeated", "int8"])
def test_streams_match_reference(pair, case):
    """Text and image requests in one batch; the same (image, prompt) three
    times in waves, then another image (the repeats hit the image's pages,
    the other image nothing: the reference's exact prefix hits); int8 KV
    pages.  Streams and counters equal the reference engine's."""
    cfg = pair[2].cfg
    img_a, img_b, prompt, text = _reqs(cfg, 4)
    if case == "mixed":
        _both(pair, [(text, None, 5), (prompt, img_a, 5), (text[:6], None, 4),
                     (prompt[:4], img_b, 5)])
    elif case == "repeated":
        got, stats = _both(pair, [(prompt, img_a, 4)] * 3
                           + [(prompt, img_b, 4)], waves=True)
        assert stats["prefix_hits"] == 2
        assert stats["prefix_hit_tokens"] >= 2 * cfg.n_image_tokens
        assert got[0] == got[1] == got[2]
    else:
        _both(pair, [(prompt, img_a, 5), (text, None, 5)], kv_quant="int8")


def test_mesh_tp2_streams_match_reference(pair, tmp_path):
    """Megatron TP 2 over gloo (one thread a rank): image and text
    requests, the image repeated; every rank's streams and prefix hits are
    the reference's single-device engine's."""
    jm, jp, _, _ = pair
    cfg = pair[2].cfg
    img_a, img_b, prompt, text = _reqs(cfg, 6)
    reqs = [(prompt, img_a, 5), (text, None, 5), (prompt, img_a, 5),
            (prompt[:5], img_b, 4)]
    want, ws = _serve(JaxServeEngine, jm, jp, reqs, **R.VLM_KW)
    res = C.run_ranks(R.vlm_mesh_serve,
                      (jax.tree.map(np.asarray, jp), reqs), world=2,
                      store_dir=tmp_path, device="cpu", timeout=300)
    for r in res:
        assert r["streams"] == want
        assert r["prefix_hits"] == ws["prefix_hits"] and r["tp"] == 2


def _raises_same(port, ref, exc=ValueError):
    with pytest.raises(exc) as got:
        port()
    with pytest.raises(exc) as want:
        ref()
    assert str(got.value) == str(want.value)
    return str(got.value)


@pytest.mark.parametrize("case", ["page_size", "max_len", "count", "width",
                                  "too_long", "dense"])
def test_refusals_match_reference(pair, case):
    jm, jp, model, params = pair
    cfg = model.cfg
    I = cfg.n_image_tokens
    if case in ("page_size", "max_len"):
        kw = dict(max_slots=2, max_len=64, page_size=16) \
            if case == "page_size" else dict(max_slots=2, max_len=I + 1,
                                             page_size=8)
        msg = _raises_same(lambda: ServeEngine(model, params, device="cpu",
                                               **kw),
                           lambda: JaxServeEngine(jm, jp, **kw))
        assert ("--page-size 8" if case == "page_size" else "--max-len") \
            in msg
        return
    kw = dict(ENGINE_KW, paged=False) if case == "dense" else ENGINE_KW
    enc = {"count": np.zeros((I + 1, cfg.d_model)),
           "width": np.zeros((I, cfg.d_model - 1)),
           "too_long": _image(cfg, 0), "dense": _image(cfg, 0)}[case]
    prompt = np.arange(64 - I if case == "too_long" else 4, dtype=np.int32)
    eng = ServeEngine(model, params, device="cpu", **kw)
    jeng = JaxServeEngine(jm, jp, **kw)
    _raises_same(lambda: eng.submit(prompt, encoder_input=enc),
                 lambda: jeng.submit(prompt, encoder_input=enc))
    eng.close()
    jeng.close()


def test_text_family_refuses_encoder_input():
    """qwen2's SMOKE engine refuses an image with the reference's error."""
    jm = jax_build_model(jax_smoke_config("qwen2-7b").replace(remat="none"))
    jp = jm.init(jax.random.PRNGKey(0))
    model = build_model(smoke_config("qwen2-7b"))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    eng = ServeEngine(model, params, device="cpu", max_slots=2, max_len=64)
    jeng = JaxServeEngine(jm, jp, max_slots=2, max_len=64)
    enc = np.zeros((4, model.cfg.d_model), np.float32)
    msg = _raises_same(lambda: eng.submit(np.arange(4), encoder_input=enc),
                       lambda: jeng.submit(np.arange(4), encoder_input=enc))
    assert "takes no encoder_input" in msg


def test_traffic_image_band_matches_reference(pair):
    """Two sessions over two images: the port's event log, streams and
    report under the virtual clock are the reference's, and the repeated
    images hit the prefix cache."""
    jm, jp, model, params = pair
    cfg = model.cfg
    kw = dict(kind="poisson", n_requests=8, rate=1.0, vocab=cfg.vocab,
              seed=5, max_new_tokens=4, shared_prefix_len=8, n_sessions=2,
              len_mix=((1.0, 4, 10),), encoder="image",
              encoder_shape=(cfg.n_image_tokens, cfg.d_model),
              encoder_frac=1.0, n_encoder_inputs=2)
    eng_kw = dict(max_slots=3, max_len=64, page_size=8, prefill_chunk=8)
    eng = ServeEngine(model, params, device="cpu", **eng_kw)
    got = TR.run_traffic(eng, TR.make_workload(**kw))
    hits = eng.stats["prefix_hit_tokens"]
    eng.close()
    jeng = JaxServeEngine(jm, jp, **eng_kw)
    want = JTR.run_traffic(jeng, JTR.make_workload(**kw))
    jeng.close()
    assert got["events"] == want["events"]
    assert got["outputs"] == want["outputs"]
    assert got["report"] == want["report"]
    assert hits >= cfg.n_image_tokens


_TIMES = re.compile(r" in [0-9.]+s \([0-9.]+ tok/s\)| mean TTFT \d+ms")


def _summary(out: str) -> list:
    return [_TIMES.sub("", ln) for ln in out.splitlines()
            if ln.startswith("[serve]") and "kernels:" not in ln
            and "kv_bytes_per_token" not in ln]


def test_launcher_image_matches_reference(tmp_path, monkeypatch, capsys):
    """``--arch llava-next-mistral-7b --smoke --image --page-size 8``: the
    closed-loop summary (times aside; the prefix hits of the alternating
    images included) and a virtual-clock traffic report with the image
    band equal the reference launcher's; ``--image --disagg`` is refused
    with its message."""
    argv = ["--arch", "llava-next-mistral-7b", "--smoke", "--image",
            "--page-size", "8", "--slots", "2", "--requests", "4",
            "--max-new", "4",
            "--max-len", "64", "--shared-prefix", "8"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jax_launch.main()
    want = _summary(capsys.readouterr().out)
    launch.main(argv + ["--device", "cpu"])
    got = _summary(capsys.readouterr().out)
    assert got == want
    assert any("prefix cache: hits=" in ln and "hits=0 " not in ln
               for ln in got)
    traffic = argv + ["--traffic", "poisson", "--rate", "0.5", "--clock",
                      "virtual", "--encoder-frac", "0.5"]
    monkeypatch.setattr(sys, "argv", ["serve"] + traffic + [
        "--metrics-out", str(tmp_path / "ref.json")])
    jax_launch.main()
    launch.main(traffic + ["--device", "cpu", "--metrics-out",
                           str(tmp_path / "port.json")])
    capsys.readouterr()
    assert json.loads((tmp_path / "port.json").read_text())["report"] \
        == json.loads((tmp_path / "ref.json").read_text())["report"]
    bad = argv + ["--disagg"]
    monkeypatch.setattr(sys, "argv", ["serve"] + bad)
    with pytest.raises(SystemExit) as want_exit:
        jax_launch.main()
    with pytest.raises(SystemExit) as got_exit:
        launch.main(bad + ["--device", "cpu"])
    assert str(got_exit.value) == str(want_exit.value)
