"""rwkv6 and zamba2 training over a ``("data", "model")`` mesh (ROADMAP
A13b item 4b) against the reference's single-device training and the
port's one-device step, on the CPU over gloo (worlds 2 and 4, each spawned
once for the file, rank body :func:`_torch_ranks.recurrent_mesh`, one
thread a rank), from bridged SMOKE weights, float32, on
tests/test_torch_recurrent_train.py's batches (B 4, S 32, seed 2:
``_torch_ranks.rec_task``):

* meshes (1, 2), (2, 1), (2, 2) and (1, 4).  A rank holds S / tp
  positions of B / dp rows; the scans run on H / tp whole heads over
  every position (rwkv6 SMOKE has 4 heads: one a rank at (1, 4), where
  zamba2's conv history of 3 rows crosses blocks of 8);
* one step's loss and every gradient leaf, gathered whole, against
  ``jax.value_and_grad`` of the reference's single-device ``model.loss``
  (its own meshed loss is red under this jax: ROADMAP Queue C), and
  against the port's one-device step on the same batch;
* five ``Trainer`` steps against the port's one-device ``Trainer`` and
  against the reference's AdamW steps on the same batches;
* the exchanges alone (``TrainMesh.prev_rows``, ``seq_to_heads`` and
  ``heads_to_seq``) against their serial composition, forward and
  gradient;
* a (1, 1) mesh of one rank at bf16 compute: loss and gradients bit for
  bit the one-device step's (the card runs this layout);
* the refusals, without a group: heads that do not split over the
  sequence's blocks, and a block shorter than the conv's history.

Limits: the reference's as in tests/test_torch_recurrent_train.py
(``LOSS_REL``, ``GRAD_REL``, ``STEPS_REL``, which says why zamba2's later
gradient norms are held finite only).  Against the port's one-device
step the loss within 1e-6 of its value and each leaf within
``ONE_DEVICE_REL`` of its largest magnitude: 1e-5 for rwkv6 (measured
8.3e-7).  zamba2 SMOKE's gradients are decided by rounding at a finer
level than that: its one-device step on weights moved by 1e-7 of their
size (a float32 rounding) moves a leaf by up to 1.0e-4 of its largest
magnitude (rwkv6's by 2.7e-6), and the mesh's summation order (the loss
chunks, the sums of B's and C's gradients over the ranks) moved one by
2.0e-5 at (1, 4) and by at most 1.3e-6 at the other meshes, with the
loss equal: its limit is 5e-5.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as R
from repro.configs import smoke_config as jax_smoke_config
from repro.models.api import build_model as jax_build_model
from repro.optim import adamw as JO
from repro_torch.bridge import params_from_numpy
from repro_torch.core import comm as C
from repro_torch.data import make_data_iter
from repro_torch.mesh.axes import rules_for_mesh
from repro_torch.models.module import tree_map
from repro_torch.optim import adamw as PO
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train.step import train_mesh

LOSS_REL = 1e-6
GRAD_REL = {"rwkv6-3b": 1e-4, "zamba2-7b": 3e-4}
STEPS_REL = {"rwkv6-3b": (1e-5, 1e-5, 1e-5), "zamba2-7b": (2e-4, 1e-4, None)}
ONE_DEVICE_REL = {"rwkv6-3b": 1e-5, "zamba2-7b": 5e-5}
MESHES = [(n, shape) for n, shapes in sorted(R.REC_MESHES.items())
          for shape in shapes]
CASES = [(n, shape, arch) for n, shape in MESHES for arch in R.REC_ARCHS]
CASE_IDS = [f"{a}x{b}-{arch}" for _, (a, b), arch in CASES]
MESH_IDS = [f"{a}x{b}" for _, (a, b) in MESHES]


def _tree(arch):
    """SMOKE weights as numpy float32: the port's seeded init (the
    reference's tree, leaf for leaf) nudged off its zeros and ones by
    seeded noise (decay bases, biases)."""
    init = R.rec_model(arch).init(0, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(0)
    return tree_map(lambda t: (t.numpy() + 0.02 * rng.normal(size=t.shape))
                    .astype(np.float32), init)


@pytest.fixture(scope="module")
def weights():
    return {arch: _tree(arch) for arch in R.REC_ARCHS}


@pytest.fixture(scope="module")
def worlds(weights, tmp_path_factory):
    """world -> every rank's :func:`_torch_ranks.recurrent_mesh` results."""
    return {n: C.run_ranks(R.recurrent_mesh, (weights,), world=n,
                           store_dir=tmp_path_factory.mktemp(f"rec{n}"),
                           device="cpu", timeout=600)
            for n in sorted(R.REC_MESHES)}


def _walk(tree, got, path=()):
    """(path, leaf of ``tree`` as numpy, the same leaf of ``got``)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, got[k], path + (k,))
        else:
            yield path + (k,), np.asarray(v), got[k]


def _grads_within(want, got, rel, what):
    n = 0
    for path, w, g in _walk(want, got):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        err = float(np.abs(g - w).max())
        limit = rel * float(np.abs(w).max())
        assert err <= limit, f"{what} {path}: max abs err {err} > {limit}"
        n += 1
    return n


@pytest.fixture(scope="module")
def reference(weights):
    """arch -> the reference's single-device step on batch 0 (loss,
    tokens, grads) and its five AdamW steps on the trainer's batches, and
    the port's five one-device trainer steps with the first one's
    gradients (one thread: SMOKE sizes)."""
    out = {}
    jopt = JO.AdamWConfig(**R.TRAIN_OPT5)
    update = jax.jit(lambda p, g, o: JO.adamw_update(p, g, o, jopt))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for arch in R.REC_ARCHS:
            model = R.rec_model(arch)
            jmodel = jax_build_model(jax_smoke_config(arch))
            task = R.rec_task(model.cfg)
            vg = jax.jit(jax.value_and_grad(
                lambda p, b: jmodel.loss(p, b, None), has_aux=True))
            jp = jax.tree.map(jnp.asarray, weights[arch])
            ost = JO.adamw_init(jp, jopt)
            hist = []
            for i in range(5):
                (jloss, jmet), jg = vg(jp, {k: jnp.asarray(v.numpy())
                                            for k, v in
                                            task.batch_at(i).items()})
                if i == 0:
                    out[arch] = {"loss": float(jloss),
                                 "tokens": float(jmet["tokens"]),
                                 "grads": jg}
                jp, ost, st = update(jp, jg, ost)
                hist.append({"step": i + 1, "loss": float(jloss),
                             "grad_norm": float(st["grad_norm"]),
                             "lr": float(st["lr"])})
            params = tree_map(lambda t: t.requires_grad_(True),
                              params_from_numpy(weights[arch], device="cpu",
                                                defs=model.param_defs()))
            tr = Trainer(model, PO.AdamWConfig(**R.TRAIN_OPT5),
                         TrainerConfig(steps=5, log_every=100),
                         make_data_iter(task, device="cpu"), device="cpu",
                         params=params, log=lambda s: None)
            with R.first_step_grads(lambda g: tree_map(
                    lambda t: t.detach().numpy().copy(), g)) as first:
                port = tr.fit()["history"]
            out[arch].update(history=hist, port_history=port,
                             port_grads=first["grads"])
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.mark.parametrize("n,shape,arch", CASES, ids=CASE_IDS)
def test_mesh_step_matches_reference(worlds, reference, n, shape, arch):
    """The first trainer step's loss on every rank and its gradients,
    gathered whole, against the reference's single-device step."""
    want = reference[arch]
    firsts = [r[shape, arch]["history"][0] for r in worlds[n]]
    for first in firsts:
        assert first["tokens"] == want["tokens"] == R.REC_B * R.TRAIN_S
        assert abs(first["loss"] - want["loss"]) <= LOSS_REL * abs(
            want["loss"])
        assert first["loss"] == firsts[0]["loss"]
    assert _grads_within(want["grads"], worlds[n][0][shape, arch]["grads"],
                         GRAD_REL[arch], f"{arch} mesh {shape}") == len(
        jax.tree.leaves(want["grads"]))


@pytest.mark.parametrize("n,shape,arch", CASES, ids=CASE_IDS)
def test_mesh_step_matches_one_device(worlds, reference, n, shape, arch):
    """The first trainer step against the port's one-device one."""
    want = reference[arch]
    got = worlds[n][0][shape, arch]
    loss = want["port_history"][0]["loss"]
    assert abs(got["history"][0]["loss"] - loss) <= 1e-6 * abs(loss)
    _grads_within(want["port_grads"], got["grads"], ONE_DEVICE_REL[arch],
                  f"{arch} mesh {shape} against one device")


def _history_close(got, want, arch, what):
    """Five steps of ``got`` against ``want``'s under STEPS_REL."""
    loss_rel, first_rel, later_rel = STEPS_REL[arch]
    assert len(want) == 5
    for a, b in zip(got, want):
        assert a["lr"] == pytest.approx(b["lr"], rel=1e-6)
        assert np.isfinite(a["grad_norm"])
        for key, rel in (("loss", loss_rel), ("grad_norm", first_rel
                                              if a["step"] == 1
                                              else later_rel)):
            if rel is not None:
                assert a[key] == pytest.approx(b[key], rel=rel), \
                    (arch, what, a["step"], key, a[key], b[key])


@pytest.mark.parametrize("n,shape,arch", CASES, ids=CASE_IDS)
def test_mesh_five_trainer_steps(worlds, reference, n, shape, arch):
    """Five trainer steps on every rank against the port's one-device
    trainer, and against the reference's AdamW steps."""
    want = reference[arch]
    for r in worlds[n]:
        got = r[shape, arch]["history"]
        assert len(got) == 5 and got[-1]["loss"] < got[0]["loss"]
        _history_close(got, want["port_history"], arch,
                       f"mesh {shape} against one device")
        _history_close(got, want["history"], arch,
                       f"mesh {shape} against the reference")


@pytest.mark.parametrize("n,shape", MESHES, ids=MESH_IDS)
def test_exchanges_match_serial(worlds, n, shape):
    """Every rank's seq_to_heads is the whole tensor's block of heads, its
    heads_to_seq gives the block back, and the gradient of its block is
    the cotangent's block over every head; prev_rows gives the n rows
    before its block (zeros on the first), one float32 and one float64
    tensor, and its gradient lands on the last n rows of the block before
    (none on the last block)."""
    ins = R.exchange_inputs()
    x, z, g_prev = ins["x"], ins["z"], ins["g_prev"]
    B, S, H, Cw, k = (R.EXCHANGE[c] for c in "BSHCn")
    tp = shape[1]
    s, h = S // tp, H // tp
    xf, zf = x.reshape(B, S, H * Cw), z.reshape(B, S, H * Cw)
    for rank, r in enumerate(worlds[n]):
        i = rank % tp
        blk = slice(i * s, (i + 1) * s)
        got = {key: v.numpy() for key, v in r[shape, "exchange"].items()}
        np.testing.assert_array_equal(got["heads"],
                                      x[:, :, i * h:(i + 1) * h])
        np.testing.assert_array_equal(got["z_heads"],
                                      z[:, :, i * h:(i + 1) * h])
        np.testing.assert_array_equal(got["back"], x[:, blk])
        np.testing.assert_array_equal(got["d_heads"], ins["g_heads"][:, blk])
        prev = slice(i * s - k, i * s)
        want = xf[:, prev] if i else np.zeros((B, k, H * Cw), np.float32)
        np.testing.assert_array_equal(got["prev"], want)
        np.testing.assert_array_equal(
            got["z_prev"], zf[:, prev] if i else np.zeros((B, k, H * Cw)))
        d = np.zeros((B, s, H * Cw), np.float32)
        if i + 1 < tp:
            d[:, s - k:] = g_prev[:, (i + 1) * k:(i + 2) * k]
        np.testing.assert_array_equal(got["d_prev"], d)


@pytest.mark.parametrize("arch", R.REC_ARCHS)
def test_world_one_bf16_bit_for_bit(weights, tmp_path, arch):
    """bf16 compute on a (1, 1) mesh of this one rank: the loss and every
    gradient leaf the one-device step's, bit for bit (the exchanges are
    copies, the float32-declared leaves stay float32 through the
    gathers)."""
    r = C.run_ranks(R.recurrent_world_one, (weights[arch], arch), world=1,
                    store_dir=tmp_path, device="cpu")[0]
    assert len(r[True]) == len(r[False])
    for a, b in zip(r[True], r[False]):
        assert a.dtype == b.dtype and torch.equal(a, b)


class _NoGroupMesh:
    """A ("data", "model") mesh of shape (1, tp) seen from its rank 0, with
    no process group: what TrainMesh's checks read, which run before any
    collective."""

    index = C.Mesh.index

    def __init__(self, tp: int):
        self.axis_names = R.DM
        self.shape = {"data": 1, "model": tp}
        self.coords = {"data": 0, "model": 0}

    def comm(self, name):
        return types.SimpleNamespace(size=lambda: self.shape[name])


@pytest.mark.parametrize("arch,tp,S,match", [
    ("rwkv6-3b", 8, 32, "4 heads do not split"),
    ("zamba2-7b", 16, 32, "8 heads do not split"),
    ("zamba2-7b", 4, 8, "block of 2 positions is shorter than the 3"),
], ids=["rwkv6-heads", "zamba2-heads", "zamba2-halo"])
def test_split_refusals(arch, tp, S, match):
    """``loss(mesh=)`` refuses, before any collective, heads that do not
    split over the sequence's tp blocks (each rank's scan takes whole
    heads) and a block of S / tp positions shorter than the conv's K - 1
    rows of history; so do the exchanges themselves."""
    model = R.rec_model(arch)
    mesh = _NoGroupMesh(tp)
    tm = train_mesh(model, mesh, rules_for_mesh(mesh))
    tokens = torch.zeros(2, S // tp, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        model.loss({}, {"tokens": tokens, "labels": tokens}, mesh=tm)
    x = torch.zeros(2, S // tp, 3, 5)
    with pytest.raises(ValueError, match="do not split"):
        tm.seq_to_heads(x)
    with pytest.raises(ValueError, match="shorter than"):
        tm.prev_rows([x.flatten(2)], S // tp + 1)
