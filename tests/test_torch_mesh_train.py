"""Training over a mesh (the port's ZeRO-3 state, sequence parallelism on
``"model"``, pod data parallelism) on gloo, held against the reference's
**single-device** training on the same bridged SMOKE qwen3-1.7b weights
(tp=2, as the reference's sharded test sets it; B 8, S 32).  The
reference's own sharded tests are red (ROADMAP Queue C), so they are no
oracle.

Worlds 4 and 2 are spawned once each for the file
(:func:`_torch_ranks.mesh_train`, one thread a rank): ``("data", "model")``
meshes (2, 1) and (1, 2) at world 2 and (2, 2) at world 4, each with one
step (loss within 1e-4, every gathered param within the reference test's
``rtol 2e-4, atol 2e-5``), two microbatches, the eval loss, the seeded
sharded init gathered (bit for bit the unsharded state), five trainer
steps (losses and gradient norms within 1e-5 relative); the (2, 2) run
checkpoints and world 2 resumes from it on (2, 1), this process unmeshed
(the next loss within 1e-5 of the uninterrupted run); ``NanGuard`` rolls
back on every rank; pod-DP on ``("pod", "data", "model")`` (2, 2, 1) and
(2, 1, 2): the reference test's properties and the reference's pod-DP
arithmetic composed on one device from its parts; ``compressed_psum`` at
worlds 2 and 4 against the reference's quantizer; the launcher's
``--mesh debug`` at 8 ranks.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as R
from repro.configs import smoke_config as jax_smoke_config
from repro.models.api import build_model as jax_build_model
from repro.optim import adamw as JO
from repro.optim.compress import int8_compress, int8_decompress
from repro.train import Trainer as JTrainer, TrainerConfig as JTrainerConfig
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.core import comm as C
from repro_torch.launch import train as launch_train
from repro_torch.mesh.axes import rules_for_mesh
from repro_torch.models.module import shard_leaf, tree_map
from repro_torch.optim import AdamWConfig
from repro_torch.data import make_batch_fn
from repro_torch.train import (create_train_state, make_train_step,
                               restore_checkpoint)

STEP_LOSS, PARAM_RTOL, PARAM_ATOL = 1e-4, 2e-4, 2e-5   # the reference test's
STEPS_REL = 1e-5
GRAD_REL = 1e-4          # a moment leaf within this of its largest magnitude
ILL_COND = 100 * 1e-8    # |g| under which Adam's first step is ill-conditioned
POD_REL = 1e-4
PSUM_TOL = 1e-6
MESHES = [(2, (2, 1)), (2, (1, 2)), (4, (2, 2))]
MESH_IDS = [f"{a}x{b}" for _, (a, b) in MESHES]
POD_IDS = ["x".join(map(str, s)) for s in R.POD_MESHES]


@functools.lru_cache(maxsize=None)
def _jbatch(step):
    """The synthetic batch ``step`` as the reference takes it (the port's
    batches are the reference's bit for bit: tests/test_torch_data.py)."""
    batch = R.train_task(R.train_model().cfg).batch_at(step)
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


@pytest.fixture(scope="module")
def ref():
    """The reference model (remat none, tp 2), seeded SMOKE weights as its
    params, and as numpy (what the ranks bridge)."""
    jm = jax_build_model(jax_smoke_config("qwen3-1.7b").replace(
        remat="none", tp=2))
    w = tree_map(lambda t: t.numpy(), R.train_model().init(
        0, device="cpu", dtype=torch.float32))
    return jm, jax.tree.map(jnp.asarray, w), w


@pytest.fixture(scope="module")
def want(ref):
    """The reference's single-device step (and with two microbatches), its
    eval loss and five trainer steps."""
    jm, jp, _ = ref
    out = {}
    opt = JO.AdamWConfig(**R.TRAIN_OPT1)
    for accum in (1, 2):
        st = {"params": jp, "opt": JO.adamw_init(jp, opt)}
        st, m = jmake_train_step(jm, opt, accum_steps=accum,
                                 donate=False)(st, _jbatch(0))
        out["step", accum] = (st, m)
    out["eval"] = float(out["step", 1][1]["loss"])   # the loss before it
    opt5 = JO.AdamWConfig(**R.TRAIN_OPT5)
    tr = JTrainer(jm, opt5, JTrainerConfig(steps=5, log_every=100),
                  iter([_jbatch(i) for i in range(5)]), log=lambda s: None)
    fresh = jax.tree.map(jnp.array, jp)      # the trainer donates its state
    tr._initialize = lambda: ({"params": fresh,
                               "opt": JO.adamw_init(fresh, opt5)}, 5)
    out["history"] = tr.fit()["history"]
    return out


@pytest.fixture(scope="module")
def worlds(ref, tmp_path_factory):
    """world -> every rank's :func:`_torch_ranks.mesh_train` results; world
    4 runs first (its (2, 2) trainer writes the checkpoints world 2 resumes
    from)."""
    _, _, w = ref
    ckpt = tmp_path_factory.mktemp("ckpt")
    out = {"ckpt": str(ckpt)}
    for n in (4, 2):
        out[n] = C.run_ranks(
            R.mesh_train, (w, str(ckpt)),
            kwargs={"resume_dir": str(ckpt) if n == 2 else None}, world=n,
            store_dir=tmp_path_factory.mktemp(f"train{n}"), device="cpu",
            timeout=900)
    return out


class _At:
    """A rank's place on a mesh (``Mesh.index`` of its coordinates), to cut
    the shard that rank holds."""

    def __init__(self, coords, shape):
        self.coords, self.shape = coords, shape

    def index(self, axes):
        idx, n = 0, 1
        for a in ((axes,) if isinstance(axes, str) else axes):
            idx, n = idx * self.shape[a] + self.coords[a], n * self.shape[a]
        return idx, n


def _walk(jtree, got, path=()):
    for k, v in jtree.items():
        if isinstance(v, dict):
            yield from _walk(v, got[k], path + (k,))
        else:
            yield path + (k,), np.asarray(v), got[k]


@pytest.mark.parametrize("n,shape", MESHES, ids=MESH_IDS)
def test_one_step_matches_single_device(worlds, want, n, shape):
    """The loss within 1e-4 on every rank; every gathered param within the
    reference test's limits, and every first moment (0.1 x the gradient)
    within 1e-4 of its leaf's largest.  A first Adam step moves a weight by
    lr g / (|g| + eps): where the reference's |g| is below ILL_COND (100
    eps) that quotient turns a summation-order gap in g into a visible one
    in the weight, so there the weight is held through its moment only."""
    st, m = want["step", 1]
    res = worlds[n]
    for r in res:
        got = r["train", shape]["step", 1]
        assert abs(got["loss"] - float(m["loss"])) < STEP_LOSS
        assert got["loss"] == res[0]["train", shape]["step", 1]["loss"]
    got = res[0]["train", shape]["step", 1]
    moments = {p: (w, g) for p, w, g in _walk(st["opt"]["m"], got["m"])}
    for path, w, g in _walk(st["params"], got["params"]):
        m_ref, m_got = moments[path]
        assert np.abs(m_got - m_ref).max() <= GRAD_REL * np.abs(m_ref).max()
        ok = np.abs(m_ref) >= 0.1 * ILL_COND     # m = 0.1 g at step 1
        np.testing.assert_allclose(g[ok], w[ok], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=str(path))


@pytest.mark.parametrize("n,shape", MESHES, ids=MESH_IDS)
def test_accum_steps_two_matches_single_device(worlds, want, n, shape):
    """Two microbatches a rank (each rank's rows halved; every row scores
    all 32 tokens, so the microbatches' means weigh alike): the loss, the
    norm and the first moments of the reference's accumulated step."""
    st, m = want["step", 2]
    got = worlds[n][0]["train", shape]["step", 2]
    assert got["loss"] == pytest.approx(float(m["loss"]), rel=STEPS_REL)
    assert got["grad_norm"] == pytest.approx(float(m["grad_norm"]),
                                             rel=STEPS_REL)
    for path, w, g in _walk(st["opt"]["m"], got["m"]):
        assert np.abs(g - w).max() <= GRAD_REL * np.abs(w).max(), path


@pytest.mark.parametrize("n,shape", MESHES, ids=MESH_IDS)
def test_eval_step_matches_single_device(worlds, want, n, shape):
    for r in worlds[n]:
        assert r["train", shape]["eval"] == pytest.approx(want["eval"],
                                                          rel=STEPS_REL)


@pytest.mark.parametrize("n,shape", MESHES, ids=MESH_IDS)
def test_sharded_init_gathers_bit_for_bit(worlds, n, shape):
    """The state drawn leaf by leaf on the mesh (each rank cutting its
    shard) gathers back to the unsharded state from the same seed."""
    model = R.train_model()
    whole = create_train_state(model, 0, AdamWConfig(**R.TRAIN_OPT1),
                               device="cpu")["params"]
    got = worlds[n][0]["train", shape]["init"]

    def walk(a, b):
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k])
            else:
                np.testing.assert_array_equal(b[k], a[k].detach().numpy())
    walk(whole, got)


@pytest.mark.parametrize("n,shape", MESHES, ids=MESH_IDS)
def test_five_trainer_steps_match_single_device(worlds, want, n, shape):
    for r in worlds[n]:
        hist = r["train", shape]["history"]
        assert len(hist) == 5
        for a, b in zip(hist, want["history"]):
            for key in ("loss", "grad_norm", "lr"):
                assert a[key] == pytest.approx(b[key], rel=STEPS_REL), \
                    (shape, a["step"], key)


def test_elastic_resume_across_worlds(worlds, want):
    """Saved on (2, 2) at world 4 after step 1; restored on (2, 1) at world
    2 (and restored whole there, then ``reshard_state``'d: the same
    shards) and unmeshed here: the next step's loss is the uninterrupted
    run's."""
    nxt = want["history"][R.CKPT_STEP]["loss"]
    for r in worlds[2]:
        assert r["resume"]["loss"] == pytest.approx(nxt, rel=STEPS_REL)
        assert r["resume"]["resharded_equal"]
    model = R.train_model()
    opt = AdamWConfig(**R.TRAIN_OPT5)
    like = create_train_state(model, 0, opt, device="cpu")
    st, step = restore_checkpoint(worlds["ckpt"], like, step=R.CKPT_STEP)
    assert step == R.CKPT_STEP
    batch = make_batch_fn(R.train_task(model.cfg))(step)
    _, m = make_train_step(model, opt)(st, batch)
    assert float(m["loss"]) == pytest.approx(nxt, rel=STEPS_REL)


def test_nan_guard_rolls_back_every_rank(worlds):
    """A NaN loss on every rank of (2, 2): each restores the newest
    checkpoint (step 5), its shard of the table that checkpoint's."""
    arr = np.load(os.path.join(worlds["ckpt"], "step_00000005",
                               "params____embed____table.npy"))
    for r in worlds[4]:
        g = r["nan"]
        assert g["healthy"] and g["step"] == 5 and g["skip"] == 1
        cut = shard_leaf(torch.from_numpy(arr), g["spec"],
                         _At(g["coords"], {"data": 2, "model": 2}))
        np.testing.assert_array_equal(g["table"], cut.numpy())


def _pod_reference(ref, compress):
    """The reference's pod-DP arithmetic on one device, from its parts:
    each pod's loss and gradient on its rows (``jax.value_and_grad`` of
    ``model.loss``), ``int8_compress`` / ``int8_decompress`` with error
    feedback and the dequantized codes summed in pod order as its host
    loop does (or the plain float64 mean), ``adamw_update``; the pods'
    mean loss a step."""
    jm, jp, _ = ref
    opt = JO.AdamWConfig(**R.POD_OPT)
    grad = jax.jit(jax.value_and_grad(lambda p, b: jm.loss(p, b, None)[0]))

    @jax.jit
    def quantize(g, e):
        def one(g, e):
            gf = g.astype(jnp.float32) + e
            q, s = int8_compress(gf)
            return q, s, gf - int8_decompress(q, s)
        out = jax.tree.map(one, g, e)
        pick = (lambda i: jax.tree.map(lambda t: t[i], out,
                                       is_leaf=lambda t: isinstance(t,
                                                                    tuple)))
        return pick(0), pick(1), pick(2)
    update = jax.jit(lambda p, g, o: JO.adamw_update(p, g, o, opt))
    params, ost = jp, JO.adamw_init(jp, opt)
    n, per = 2, R.TRAIN_B // 2
    err = [jax.tree.map(jnp.zeros_like, jp) for _ in range(n)]
    losses = []
    for i in range(R.POD_STEPS):
        b = _jbatch(i)
        wires, ls = [], []
        for p in range(n):
            loss, g = grad(params, jax.tree.map(
                lambda x: x[p * per:(p + 1) * per], b))
            ls.append(float(loss))
            if compress:
                q, s, err[p] = quantize(g, err[p])
                wires.append((q, s))
            else:
                wires.append(g)
        if compress:
            def mean(*qs_ss):
                acc = np.zeros(np.shape(qs_ss[0]), np.float32)
                for q, s in zip(qs_ss[:n], qs_ss[n:]):
                    acc += np.asarray(q).astype(np.float32) * np.float32(s)
                return acc / n
            mg = jax.tree.map(mean, *[w[0] for w in wires],
                              *[w[1] for w in wires])
        else:
            mg = jax.tree.map(lambda *gs: (sum(np.asarray(x, np.float64)
                                               for x in gs) / n)
                              .astype(np.float32), *wires)
        params, ost, _ = update(params, mg, ost)
        losses.append(float(np.mean(ls)))
    return losses


@pytest.fixture(scope="module")
def pod_want(ref):
    return {c: _pod_reference(ref, c) for c in (True, False)}


@pytest.mark.parametrize("shape", R.POD_MESHES, ids=POD_IDS)
def test_pod_dp_reference_properties(worlds, shape):
    """The reference test's: training works, int8 + error feedback tracks
    the plain mean within 0.05, the wire is under 0.3 of float32, and the
    pods stay in lockstep (every rank's whole table equal); and
    ``split_pod_meshes`` gives each rank its pod's sub-mesh."""
    res = [r["pod", shape] for r in worlds[4]]
    rest = {"data": shape[1], "model": shape[2]}
    for rank, r in enumerate(res):            # split_pod_meshes, per rank
        assert r["pods"] == [(p, rank // 2 == p, rest,
                              2 if rank // 2 == p else None)
                             for p in range(2)]
    lc = [o["loss"] for o in res[0][True]["outs"]]
    lu = [o["loss"] for o in res[0][False]["outs"]]
    assert lc[-1] < lc[0], lc
    assert abs(lc[-1] - lu[-1]) < 0.05
    last = res[0][True]["outs"][-1]
    assert last["wire_bytes"] < 0.3 * last["fp32_bytes"]
    for r in res[1:]:
        for c in (True, False):
            np.testing.assert_allclose(r[c]["table"], res[0][c]["table"],
                                       rtol=1e-6, atol=1e-7)
            assert [o["loss"] for o in r[c]["outs"]] == \
                [o["loss"] for o in res[0][c]["outs"]]


@pytest.mark.parametrize("compress", [True, False], ids=["int8", "plain"])
@pytest.mark.parametrize("shape", R.POD_MESHES, ids=POD_IDS)
def test_pod_dp_matches_composed_reference(worlds, pod_want, shape,
                                           compress):
    got = [o["loss"] for o in worlds[4][0]["pod", shape][compress]["outs"]]
    np.testing.assert_allclose(got, pod_want[compress], rtol=POD_REL)


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_psum_matches_reference_quantizer(worlds, n):
    """Two rounds (the second with the first's residual) against the
    reference's int8_compress / int8_decompress on each rank's input, the
    mean in rank order."""
    ins = [R._psum_input(r) for r in range(n)]
    err = [{k: np.zeros_like(v) for k, v in x.items()} for x in ins]
    for rnd in (1, 2):
        qs = []
        for r in range(n):
            row = {}
            for k, g in ins[r].items():
                gf = jnp.asarray(g) + jnp.asarray(err[r][k])
                q, s = int8_compress(gf)
                row[k] = (np.asarray(q), np.float32(s))
                err[r][k] = np.asarray(gf - int8_decompress(q, s))
            qs.append(row)
        for k in ins[0]:
            acc = np.zeros(ins[0][k].shape, np.float32)
            for r in range(n):
                acc += qs[r][k][0].astype(np.float32) * qs[r][k][1]
            for r, res in enumerate(worlds[n]):
                np.testing.assert_allclose(res["psum"][f"mean{rnd}"][k]
                                           .numpy(), acc / n, rtol=PSUM_TOL,
                                           atol=PSUM_TOL)
                np.testing.assert_allclose(res["psum"][f"err{rnd}"][k]
                                           .numpy(), err[r][k],
                                           rtol=PSUM_TOL, atol=PSUM_TOL)


def test_launcher_mesh_debug(capsys, tmp_path):
    """``--mesh debug --smoke --device cpu``: 8 gloo ranks on the
    reference's (4, 2) mesh, the reference launcher's summary line."""
    res = launch_train.main(["--smoke", "--device", "cpu", "--mesh",
                             "debug", "--steps", "2", "--store-dir",
                             str(tmp_path)])
    out = capsys.readouterr().out
    h = res["history"]
    assert (f"[train] qwen3-1.7b: loss {h[0]['loss']:.4f} -> "
            f"{h[-1]['loss']:.4f} over 2 steps; stragglers=[]") in out
    assert "[train] mesh: {'data': 4, 'model': 2} on 8 ranks (gloo)" in out
    # 2 steps x 2 layers, each block run again by remat in the backward
    assert res["counts"]["flash_attention"] == (0, 2 * 2 * 2)


def test_mesh_refusals():
    model = R.train_model()
    with pytest.raises(ValueError, match="pod_dp"):
        make_train_step(model, AdamWConfig(), object(), None,
                        grad_sync="compressed")
    with pytest.raises(ValueError, match="rules"):
        create_train_state(model, 0, AdamWConfig(), object(), device="cpu")
    with pytest.raises(ValueError, match="rules"):
        make_batch_fn(R.train_task(model.cfg), object())
    assert rules_for_mesh(type("M", (), {"axis_names": ("pod", "data",
                                                        "model")})()) \
        .get("batch") == ("pod", "data")
