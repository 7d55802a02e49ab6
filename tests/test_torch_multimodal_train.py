"""llava and whisper training (ROADMAP A13b item 5) against the
reference's, on the CPU, from bridged SMOKE weights and the same synthetic
batches (4 rows of 24 positions, seed 2: llava's 8 image rows and 16 text
tokens, whisper's 16 frames and 24 tokens):

* the ``vlm`` and ``audio`` batches against the reference's ``batch_at``:
  tokens and labels equal, the image and frame embeddings within
  ``EMBED_ULPS`` float32 ulps (measured: 1; ``torch.sin`` and ``jnp.sin``
  round a few percent of the values the other way), bf16 ones at full
  width within one bf16 ulp; and a rank's block of a (2, 2) mesh;
* the loss and every gradient leaf against ``jax.value_and_grad`` of the
  reference's ``model.loss``, under remat "full" and "none";
* five ``Trainer`` steps against the reference's ``Trainer``;
* one gloo world of 4 ranks at (2, 2), shared by both families (rank body
  :func:`_torch_ranks.multimodal_mesh`): the first step's loss and its
  gradients gathered whole against the port's one-device step, and its
  three trainer steps against the reference's single-device steps.  At tp
  2 llava's first sequence block is 8 image rows and 4 text rows, so a
  rank that concatenated its own image and text blocks would fail;
  whisper's encoder gradient is held apart (no double count over
  ``"model"``);
* a (1, 1) mesh of one rank at bf16 compute: loss and gradients bit for
  bit the one-device step's (the layout the card's world-1 phases run);
* the split refusal, and the float32-result product's gradient.

Limits.  Both packages compute in float32 and sum in other orders.  Each
gradient leaf is held within ``GRAD_REL`` (1e-4) of its largest
magnitude: the measured gaps are 3.1e-5 (llava, ``ln1.scale``) and 5.8e-5
(whisper, the encoder's ``ln1.scale``), and float32 cannot do better: the
reference's float32 gradients lie up to 2.4e-5 (llava) and 5.2e-5
(whisper) of a leaf's largest magnitude from a float64 run of the port,
the port's float32 up to 4.2e-5 and 1.5e-5.  The loss within 1e-6 of its
value (measured 7.6e-8 and 1.5e-7); the mesh against the port's
one-device step within ``ONE_DEVICE_REL`` of a leaf's largest magnitude
(the loss's chunks and the gradients' reduce-scatters sum in other
orders).

Trainer steps are held as tests/test_torch_recurrent_train.py holds its
families (``STEPS_REL``): whisper as rwkv6, every loss and gradient norm
within 1e-5 (measured 3.8e-7 and 9.6e-6).  llava SMOKE is conditioned as
zamba2 SMOKE is: its text rows (the table's ~0.02 entries) enter the
first RMSNorm beside image rows of ~0.7, the table's gradient is 8.74 of
the first step's norm of 8.82, and an Adam step moves each of its entries
by ~5%.  Its float32 steps after the first decide near-zero gradients'
signs by rounding: by step 5 the reference's gradient norm lies 6.4e-3
from a float64 run of the port, the port's float32 1.4e-4, while the
losses stay within 2.9e-5 and 1.8e-6 of it.  So llava's losses are held
within 2e-4, the first step's gradient norm within 1e-4 (measured
1.1e-5) and the later ones finite only: zamba2's limits.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as R
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.data import SyntheticTask as JTask, make_data_iter as jdata_iter
from repro.models.api import build_model as jax_build_model
from repro.optim import adamw as JO
from repro.train import Trainer as JTrainer, TrainerConfig as JTrainerConfig
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import comm as C
from repro_torch.data import SyntheticTask, make_data_iter
from repro_torch.mesh.axes import rules_for_mesh
from repro_torch.models import attention as A
from repro_torch.models.api import build_model
from repro_torch.models.module import tree_map
from repro_torch.optim import adamw as PO
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.train.step import train_mesh

ARCHS = R.MM_ARCHS
EMBED = {"vlm": "image_embeds", "audio": "frames"}
EMBED_ULPS = 2
LOSS_REL, GRAD_REL = 1e-6, 1e-4
# (loss, first step's gradient norm, later gradient norms; None: finite)
# of trainer steps: tests/test_torch_recurrent_train.py's limits, llava
# SMOKE's zamba2's
STEPS_REL = {"llava-next-mistral-7b": (2e-4, 1e-4, None),
             "whisper-tiny": (1e-5, 1e-5, 1e-5)}
ONE_DEVICE_REL = 1e-5


def _tree(arch):
    """SMOKE weights as numpy float32: the port's seeded init (the
    reference's tree, leaf for leaf) nudged off its zeros and ones by
    seeded noise (biases, norms)."""
    init = R.mm_model(arch).init(0, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(0)
    return tree_map(lambda t: (t.numpy() + 0.02 * rng.normal(size=t.shape))
                    .astype(np.float32), init)


def _torch_params(model, tree):
    params = params_from_numpy(tree, device="cpu", defs=model.param_defs())
    return tree_map(lambda t: t.requires_grad_(True), params)


def _walk(tree, got, path=()):
    """(path, leaf of ``tree`` as numpy, the same leaf of ``got``)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, got[k], path + (k,))
        else:
            yield path + (k,), np.asarray(v), got[k]


def _grads_within(want, got, rel, what, only=None):
    """Every leaf of ``got`` within ``rel`` of ``want``'s largest magnitude
    (the leaves under the top-level key ``only``, if given); the count."""
    n = 0
    for path, w, g in _walk(want, got):
        if only is not None and path[0] != only:
            continue
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else g
        err = float(np.abs(g - w).max())
        limit = rel * float(np.abs(w).max())
        assert err <= limit, f"{what} {path}: max abs err {err} > {limit}"
        n += 1
    return n


@pytest.fixture(scope="module")
def weights():
    return {arch: _tree(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def reference(weights):
    """arch -> the reference's loss and gradients on batch 0, its five
    trainer steps, and the port's five one-device trainer steps with the
    first one's gradients (one thread: SMOKE sizes)."""
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for arch in ARCHS:
            model = R.mm_model(arch)
            jmodel = jax_build_model(jax_smoke_config(arch))
            task = R.mm_task(model.cfg)
            batch = task.batch_at(0)
            jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
            jp = jax.tree.map(jnp.asarray, weights[arch])
            (jloss, jmet), jg = jax.value_and_grad(
                lambda p: jmodel.loss(p, jbatch, None), has_aux=True)(jp)
            jopt = JO.AdamWConfig(**R.TRAIN_OPT5)
            jtr = JTrainer(jmodel, jopt,
                           JTrainerConfig(steps=5, log_every=100),
                           jdata_iter(JTask(jmodel.cfg, batch=R.MM_B,
                                            seq_len=R.MM_S,
                                            seed=R.MM_SEED)),
                           log=lambda s: None)
            jtr._initialize = lambda: ({"params": jp,
                                        "opt": JO.adamw_init(jp, jopt)}, 5)
            tr = Trainer(model, PO.AdamWConfig(**R.TRAIN_OPT5),
                         TrainerConfig(steps=5, log_every=100),
                         make_data_iter(task, device="cpu"), device="cpu",
                         params=_torch_params(model, weights[arch]),
                         log=lambda s: None)
            with R.first_step_grads(lambda g: tree_map(
                    lambda t: t.detach().numpy().copy(), g)) as first:
                port = tr.fit()["history"]
            out[arch] = {"batch": batch, "loss": float(jloss),
                         "tokens": float(jmet["tokens"]), "grads": jg,
                         "history": jtr.fit()["history"],
                         "port_history": port, "port_grads": first["grads"]}
    finally:
        torch.set_num_threads(threads)
    return out


@pytest.fixture(scope="module")
def world(weights, tmp_path_factory):
    """Every rank's :func:`_torch_ranks.multimodal_mesh` results."""
    return C.run_ranks(R.multimodal_mesh, (weights,), world=4,
                       store_dir=tmp_path_factory.mktemp("mm"),
                       device="cpu", timeout=600)


class _At:
    """A mesh seen from one rank, no group: what a batch's cut reads."""

    index = C.Mesh.index

    def __init__(self, coords, shape):
        self.axis_names = R.DM
        self.coords, self.shape = coords, shape

    def comm(self, name):
        return types.SimpleNamespace(size=lambda: self.shape[name])


@pytest.mark.parametrize("arch,smoke,B,S,seed", [
    ("llava-next-mistral-7b", True, 4, 24, 2),
    ("whisper-tiny", True, 3, 16, 5),
    ("llava-next-mistral-7b", False, 1, 2944, 1),
    ("whisper-tiny", False, 2, 448, 0)])
def test_batches_match_reference(arch, smoke, B, S, seed):
    """Tokens and labels bit for bit, the embeddings within EMBED_ULPS
    float32 ulps of ``jnp.sin``'s (bf16 at full width: within one bf16
    ulp), every leaf's shape and dtype the reference's."""
    cfg = smoke_config(arch) if smoke else get_config(arch)
    jcfg = jax_smoke_config(arch) if smoke else jax_get_config(arch)
    task = SyntheticTask(cfg, batch=B, seq_len=S, seed=seed)
    jtask = JTask(jcfg, batch=B, seq_len=S, seed=seed)
    emb = EMBED[cfg.family]
    for step in (0, 3):
        got, want = task.batch_at(step), jtask.batch_at(step)
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            g = got[k]
            assert tuple(g.shape) == w.shape, k
            if k != emb:
                assert g.dtype == torch.int32
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
                continue
            w32 = np.asarray(w.astype(jnp.float32))
            g32 = g.float().numpy()
            if smoke:
                assert g.dtype == torch.float32
                ulp = np.spacing(np.abs(w32))
            else:
                assert g.dtype == torch.bfloat16
                ulp = np.abs(w32) * 2.0 ** -7
            assert float((np.abs(g32 - w32) / ulp).max()) <= (
                EMBED_ULPS if smoke else 1.0)
    if cfg.family == "vlm":
        I = cfg.n_image_tokens
        assert (got["labels"][:, :I] == -1).all()
        assert got["tokens"].shape == (B, S - I)
        with pytest.raises(ValueError, match="must exceed them"):
            SyntheticTask(cfg, batch=B, seq_len=I, seed=seed).batch_at(0)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_block_of_a_batch(arch):
    """Rank (1, 1) of a (2, 2) mesh takes rows 2-3 of every leaf and its
    block of the sequence axis of each by its own spec: llava's text
    block, image block and label block each cut on their own length
    (:meth:`VLM.loss` rebuilds the rank's block of their concatenation),
    whisper's frames whole."""
    model = R.mm_model(arch)
    task = R.mm_task(model.cfg)
    rank = _At({"data": 1, "model": 1}, {"data": 2, "model": 2})
    got = next(make_data_iter(task, rank, rules_for_mesh(rank),
                              R.mm_specs(model), device="cpu",
                              start_step=3))
    whole = task.batch_at(3)
    assert sorted(got) == sorted(whole)
    for k, v in whole.items():
        half = v.shape[1] // 2 if k != "frames" else 0
        np.testing.assert_array_equal(got[k].numpy(), v[2:, half:].numpy())


@pytest.mark.parametrize("remat", ["full", "none"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(weights, reference, arch, remat):
    want = reference[arch]
    model = build_model(smoke_config(arch).replace(remat=remat))
    params = _torch_params(model, weights[arch])
    loss, met = model.loss(params, want["batch"])
    loss.backward()
    I = model.cfg.n_image_tokens if arch.startswith("llava") else 0
    assert float(met["tokens"]) == want["tokens"] == R.MM_B * (R.MM_S - I)
    assert abs(loss.item() - want["loss"]) <= LOSS_REL * abs(want["loss"])
    got = tree_map(lambda t: t.grad, params)
    assert _grads_within(want["grads"], got, GRAD_REL, arch) == len(
        jax.tree.leaves(want["grads"]))


def _history_close(got, want, arch, what):
    """``got``'s steps against ``want``'s first ones under STEPS_REL."""
    loss_rel, first_rel, later_rel = STEPS_REL[arch]
    assert len(got) <= len(want)
    for a, b in zip(got, want):
        assert a["lr"] == pytest.approx(b["lr"], rel=1e-6)
        assert np.isfinite(a["grad_norm"])
        for key, rel in (("loss", loss_rel), ("grad_norm", first_rel
                                              if a["step"] == 1
                                              else later_rel)):
            if rel is not None:
                assert a[key] == pytest.approx(b[key], rel=rel), \
                    (what, a["step"], key, a[key], b[key])


@pytest.mark.parametrize("arch", ARCHS)
def test_five_trainer_steps_match_reference(reference, arch):
    got = reference[arch]["port_history"]
    assert len(got) == 5
    _history_close(got, reference[arch]["history"], arch, "one device")


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_matches_one_device(world, reference, arch):
    """The (2, 2) mesh's first step: the same loss on every rank, within
    1e-6 of the port's one-device step and of the reference's, and every
    gradient leaf gathered whole against the one-device step's and the
    reference's."""
    want = reference[arch]
    firsts = [r[arch]["history"][0] for r in world]
    one = want["port_history"][0]["loss"]
    for first in firsts:
        assert first["loss"] == firsts[0]["loss"]
        assert first["tokens"] == want["tokens"]
        assert abs(first["loss"] - one) <= 1e-6 * abs(one)
        assert abs(first["loss"] - want["loss"]) <= LOSS_REL * abs(
            want["loss"])
    grads = world[0][arch]["grads"]
    n = _grads_within(want["port_grads"], grads, ONE_DEVICE_REL,
                      f"{arch} mesh against one device")
    assert n == len(jax.tree.leaves(want["grads"]))
    _grads_within(want["grads"], grads, GRAD_REL,
                  f"{arch} mesh against the reference")


def test_whisper_encoder_gradient_counted_once(world, reference):
    """Each rank of "model" runs the whole encoder for its rows but its
    decoder block's cotangent only: the gathers' reduce-scatter sums the
    two halves once (a second sum, or a mean, would be 2x or 0.5x)."""
    arch = "whisper-tiny"
    want, got = reference[arch]["port_grads"], world[0][arch]["grads"]
    for key in ("enc_blocks", "enc_norm"):
        assert _grads_within(want, got, ONE_DEVICE_REL, "encoder",
                             only=key)
    w, g = want["enc_blocks"]["attn"]["wq"], got["enc_blocks"]["attn"]["wq"]
    ratio = float((g * w).sum() / (w * w).sum())
    assert ratio == pytest.approx(1.0, abs=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_trainer_steps_match_reference(world, reference, arch):
    """Three trainer steps on every rank of the (2, 2) mesh against the
    reference's single-device steps and the port's one-device ones."""
    for r in world:
        got = r[arch]["history"]
        assert len(got) == R.MM_STEPS
        _history_close(got, reference[arch]["history"], arch,
                       "mesh against the reference")
        _history_close(got, reference[arch]["port_history"], arch,
                       "mesh against one device")


@pytest.mark.parametrize("arch", ARCHS)
def test_world_one_bf16_bit_for_bit(weights, tmp_path, arch):
    """bf16 compute on a (1, 1) mesh of this one rank: the loss and every
    gradient leaf the one-device step's, bit for bit (the gathers are
    copies, and llava's rebuilt block is the whole concatenation)."""
    r = C.run_ranks(R.multimodal_world_one, (weights[arch], arch), world=1,
                    store_dir=tmp_path, device="cpu")[0]
    assert len(r[True]) == len(r[False])
    for a, b in zip(r[True], r[False]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_vlm_split_refusal():
    """``loss(mesh=)`` refuses, before any collective, image rows or text
    that do not split over the sequence's blocks (8 image rows and 16 text
    tokens over 3 blocks)."""
    model = R.mm_model("llava-next-mistral-7b")
    mesh = _At({"data": 0, "model": 0}, {"data": 1, "model": 3})
    tm = train_mesh(model, mesh, rules_for_mesh(mesh))
    batch = {"tokens": torch.zeros(2, 5, dtype=torch.int32),
             "image_embeds": torch.zeros(2, 3, model.cfg.d_model),
             "labels": torch.zeros(2, 8, dtype=torch.int32)}
    with pytest.raises(ValueError, match="n_image_tokens=8, text tokens=16 "
                       "do not split over the 3 sequence blocks"):
        model.loss({}, batch, mesh=tm)


def test_float32_result_product_gradient(monkeypatch):
    """The card's bf16 product with a float32 result has no gradient of
    its own in torch: ``_MatmulF32``'s (its float32 cotangent rounded to
    bf16 once, each operand's gradient a bf16 product) against autograd
    through the widened product, within two bf16 roundings of the largest
    gradient, the card's product stood in for by the CPU's."""
    monkeypatch.setattr(A, "_bmm_f32", lambda a, b: a.float() @ b.float())
    g = torch.Generator().manual_seed(0)
    a, b, cot = (torch.randn(*s, generator=g) for s in
                 ((2, 3, 5, 4), (2, 3, 4, 6), (2, 3, 5, 6)))
    a16, b16 = (t.to(torch.bfloat16).requires_grad_(True) for t in (a, b))
    out = A._MatmulF32.apply(a16, b16)
    assert out.dtype == torch.float32
    got = torch.autograd.grad(out, (a16, b16), cot)
    wide = [t.detach().float().requires_grad_(True) for t in (a16, b16)]
    want = torch.autograd.grad(wide[0] @ wide[1], wide, cot)
    for x, w in zip(got, want):
        assert x.dtype == torch.bfloat16 and x.shape == w.shape
        assert (x.float() - w).abs().max() <= 2 * 2.0 ** -8 * w.abs().max()
