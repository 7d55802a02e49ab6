"""MoE training of the port (ROADMAP A13b item 3) and ``remat="dots"``
(item 6) against the reference's, on the CPU, from bridged SMOKE weights
and the same synthetic batches (B 8, S 32, float32):

* qwen3-moe and arctic (its dense residual MLP beside the experts):
  ``lm_loss``, its ``ce`` and ``aux``, and every leaf's gradient against
  ``jax.value_and_grad`` of the reference's loss, at the config's capacity
  factor (tokens drop) and at 8.0 (none do);
* every layer's MoE block on the inputs the port's forward fed it: its
  routes are the reference's block's on the same inputs, a flipped route
  named with its top-k margin (the k-th against the (k+1)-th
  probability), and its output within float32 rounding;
* five ``Trainer`` steps against the reference's ``Trainer``; one step
  with bf16 moments against the reference's ``AdamWConfig(moment_dtype=
  bfloat16)``;
* the dispatch's backward: the same bits over two runs, and every
  accumulating scatter of the block's backward adds at most one nonzero
  row into any target row (so a card's atomics add them exactly in any
  order);
* ``remat`` none / dots / full: bit-equal losses and gradients on a dense
  and an MoE model, ``dots`` recomputing no 2-D product in the backward
  pass, and ``dots`` against the reference's ``remat="dots"``;
* over a mesh (gloo; worlds 2 and 4, each spawned once for the file, rank
  body :func:`_torch_ranks.moe_train`): ``("data", "model")`` meshes
  (1, 2), (2, 1) and (2, 2), the experts split over ``"model"``.  The
  reference's own meshed loss is red under this jax (its embedding's
  gather fails: ROADMAP Queue C), so the oracle is its single-device loss
  composed per data block: ``ce`` over the whole batch, ``aux`` the mean
  over the data blocks of the loss's aux on each block's rows (a rank's
  router statistics are averaged over ``"model"``, the aux over the mesh,
  as in the reference's ``shard_map`` body).  Capacity factor 8.0, so no
  rank's capacity drops a token; one step's loss, ce, aux and gathered
  gradients, five trainer steps, the sharded init gathered bit for bit;
  at the config's factor the block alone, each rank's output the
  reference's serial block on that rank's tokens.

Tolerances are tests/test_torch_train.py's: float32 on both sides,
summation order only.  Loss, ce and aux within 1e-6 of their value; each
gradient leaf within 1e-4 of its largest magnitude; five trainer steps'
losses within 1e-5, their gradient norms within the gradients' 1e-4
(:func:`test_five_trainer_steps_match_reference` says why).  bf16 moments: one bf16 rounding
of a moment (2**-8 of it) on top, so each moment leaf within 2**-7 of its
largest magnitude.  A block's output within 1e-5 of its largest.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import _torch_ranks as R
from repro.configs import smoke_config as jax_smoke_config
from repro.core.comm import SerialComm as JSerialComm
from repro.data import SyntheticTask as JTask, make_data_iter as jdata_iter
from repro.models import moe as JM
from repro.models.api import build_model as jax_build_model
from repro.optim import adamw as JO
from repro.train import Trainer as JTrainer, TrainerConfig as JTrainerConfig
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import smoke_config
from repro_torch.core import comm as C
from repro_torch.data import SyntheticTask, make_data_iter
from repro_torch.models import moe as M
from repro_torch.models.api import build_model
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.optim import adamw as PO
from repro_torch.train import (Trainer, TrainerConfig, create_train_state,
                               make_train_step)

LOSS_REL, GRAD_REL, STEPS_REL = 1e-6, 1e-4, 1e-5
MOMENT_BF16_REL = 2.0 ** -7
BLOCK_REL = 1e-5
B, S = 8, 32
MOE = "qwen3-moe-235b-a22b"
ARCHS = [MOE, "arctic-480b"]
CFS = [None, 8.0]                 # None: the config's own 1.25
MESHES = [(2, (1, 2)), (2, (2, 1)), (4, (2, 2))]
MESH_IDS = [f"{a}x{b}" for _, (a, b) in MESHES]
aten = torch.ops.aten


def _cfg(arch, cf=None, **kw):
    """The port's and the reference's SMOKE config of ``arch``, with a
    capacity factor ``cf`` when given."""
    if cf is not None:
        kw["capacity_factor"] = cf
    return smoke_config(arch).replace(**kw), \
        jax_smoke_config(arch).replace(**kw)


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """Seeded SMOKE weights (the reference's init, jittered from numpy)."""
    jm = jax_build_model(jax_smoke_config(arch))
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.02 * rng.normal(size=a.shape))
        .astype(np.float32), jm.init(jax.random.PRNGKey(0)))


def _torch_params(model, tree):
    params = params_from_numpy(tree, device="cpu", defs=model.param_defs())
    return tree_map(lambda t: t.requires_grad_(True), params)


def _batch(cfg, step=0):
    return SyntheticTask(cfg, batch=B, seq_len=S, seed=2).batch_at(step)


def _jbatch(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def _walk(jtree, got, path=()):
    """(path, reference leaf as numpy, the port's leaf) of every leaf."""
    for k, v in jtree.items():
        if isinstance(v, dict):
            yield from _walk(v, got[k], path + (k,))
        else:
            yield path + (k,), np.asarray(v), got[k]


def _assert_grads(jgrads, grads, what):
    for path, want, got in _walk(jgrads, grads):
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        err = float(np.abs(got - want).max())
        limit = GRAD_REL * float(np.abs(want).max())
        assert err <= limit, f"{what} {path}: max abs err {err} > {limit}"


def _assert_close(got, want, what, rel=LOSS_REL):
    assert abs(got - want) <= rel * abs(want), (what, got, want)


def _reference_loss(jcfg, tree, batch):
    jm = jax_build_model(jcfg)
    (loss, met), grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, _jbatch(batch), None), has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    return float(loss), {k: float(v) for k, v in met.items()}, grads


@functools.lru_cache(maxsize=None)
def _jblock(jcfg):
    """The reference's serial MoE block of ``jcfg``, jitted: (x, router,
    gate, up, down) -> (y, aux, stats)."""
    return jax.jit(lambda *w: JM._dispatch_compute_combine(
        *w, jcfg, JSerialComm()))


class _Blocks:
    """Records every MoE block call of the port's forward while ``on``:
    its (T, d) input and the layer's weights."""

    def __init__(self, monkeypatch):
        self.calls, self.on = [], False
        inner = M._dispatch_compute_combine

        def spy(x2d, wr, wg, wu, wd, cfg, comm, **kw):
            if self.on:
                self.calls.append(tuple(t.detach().clone()
                                        for t in (x2d, wr, wg, wu, wd)))
            return inner(x2d, wr, wg, wu, wd, cfg, comm, **kw)
        monkeypatch.setattr(M, "_dispatch_compute_combine", spy)


def _route_flips(x, wr, k) -> tuple[list, float]:
    """The tokens whose top-k experts differ between the port's router and
    the reference's on the same float32 inputs, each with its margin
    (the k-th against the (k+1)-th probability, the reference's), and the
    smallest such margin over all tokens."""
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(wr), axis=-1)
    jp, je = jax.lax.top_k(probs, k + 1)
    tp = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(wr), dim=-1)
    te = torch.topk(tp, k, dim=-1).indices.numpy()
    margins = np.asarray(jp[:, k - 1] - jp[:, k])
    flips = [(t, sorted(te[t]), sorted(np.asarray(je[t, :k])),
              float(margins[t])) for t in range(x.shape[0])
             if set(te[t]) != set(np.asarray(je[t, :k]))]
    return flips, float(margins.min())


@pytest.mark.parametrize("cf", CFS, ids=["cf-default", "cf-8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, cf, monkeypatch):
    """The loss, its ce and aux, and every gradient leaf; then each layer's
    block on the inputs the port fed it: the reference's routes (a flip
    named with its margin) and its output.  At the config's capacity
    factor tokens drop: the loss is not the one at 8.0."""
    cfg, jcfg = _cfg(arch, cf)
    tree = _weights(arch)
    batch = _batch(cfg)
    jloss, jmet, jgrads = _reference_loss(jcfg, tree, batch)
    model = build_model(cfg)
    params = _torch_params(model, tree)
    blocks = _Blocks(monkeypatch)
    blocks.on = True
    loss, met = model.loss(params, batch)
    blocks.on = False
    grads = torch.autograd.grad(loss, tree_leaves(params))
    it = iter(grads)
    _assert_close(float(loss.detach()), jloss, "loss")
    for key in ("ce", "aux", "tokens"):
        _assert_close(float(met[key].detach()), jmet[key], key)
    _assert_grads(jgrads, tree_map(lambda _: next(it), params), arch)
    assert len(blocks.calls) == cfg.n_layers
    for layer, (x, wr, wg, wu, wd) in enumerate(blocks.calls):
        flips, margin = _route_flips(x.numpy(), wr.numpy(), cfg.top_k)
        assert not flips, (f"layer {layer}: routes flipped (token, port, "
                           f"reference, top-k margin): {flips}")
        y, aux, _ = M._dispatch_compute_combine(x, wr, wg, wu, wd, cfg,
                                                C.SerialComm())
        jy, jaux, _ = _jblock(jcfg)(
            *(jnp.asarray(t.numpy()) for t in (x, wr, wg, wu, wd)))
        err = float(np.abs(y.detach().numpy() - np.asarray(jy)).max())
        assert err <= BLOCK_REL * float(np.abs(np.asarray(jy)).max()), \
            (layer, err, margin)
        _assert_close(float(aux), float(jaux), "block aux")
    if cf is None:
        with torch.no_grad():
            wide, _ = build_model(cfg.replace(capacity_factor=8.0)).loss(
                params, batch)
        assert float(wide) != float(loss.detach())


class _Scatters(TorchDispatchMode):
    """Every accumulating index_put (the backward of a gather) and
    index_add: its flat target rows and its source rows."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet in (aten.index_put, aten.index_put_,
                      aten._index_put_impl_) and (
                args[3] if len(args) > 3 else kwargs.get("accumulate")):
            dest, idx, src = args[0], args[1], args[2]
            assert all(i is not None for i in idx), "a sliced index_put"
            lin = torch.zeros_like(idx[0], dtype=torch.long)
            for i, n in zip(idx, dest.shape):
                lin = lin * n + i.long()
            self.calls.append((packet, lin.reshape(-1),
                               src.reshape(lin.numel(), -1)))
        elif packet in (aten.index_add, aten.index_add_):
            self.calls.append((packet, args[2].reshape(-1),
                               args[3].reshape(args[2].numel(), -1)))
        return func(*args, **kwargs)


def test_dispatch_backward_is_deterministic():
    """The block's forward and backward at the config's capacity factor
    (tokens dropped) twice: the same bits.  And the property that carries
    this to a card, whose scatter-adds land in any order: in the backward
    every target row of an accumulating scatter receives at most one
    nonzero row (the combine's dropped reads all target one row, with
    zeros), so each add is exact whatever its order."""
    cfg, x, w = R.moe_inputs(tokens=40)
    runs = []
    for _ in range(2):
        xt = torch.from_numpy(x).requires_grad_(True)
        params = {k: torch.from_numpy(v).requires_grad_(True)
                  for k, v in w.items()}
        y, aux = M.moe_apply(params, xt[None], cfg)
        cot = torch.from_numpy(np.random.default_rng(5).normal(
            size=y.shape).astype(np.float32))
        mode = _Scatters()
        with mode:
            g = torch.autograd.grad((y * cot).sum() + aux,
                                    [xt, *params.values()])
        runs.append((y, aux, g, mode.calls))
    (y0, a0, g0, calls), (y1, a1, g1, _) = runs
    assert torch.equal(y0, y1) and torch.equal(a0, a1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert len(calls) >= 3, calls
    for packet, lin, src in calls:
        nonzero = src.abs().amax(dim=1) > 0
        hits = torch.bincount(lin[nonzero], minlength=1)
        assert int(hits.max()) <= 1, (packet, int(hits.max()))
    _, _, stats = M.moe_apply_expert_parallel(
        {k: torch.from_numpy(v) for k, v in w.items()},
        torch.from_numpy(x)[None], cfg, C.SerialComm())
    assert int(stats["dropped"].sum()) > 0


class _MMs(TorchDispatchMode):
    """Counts the 2-D products (aten.mm / addmm) run under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (aten.mm, aten.addmm):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", MOE])
def test_remat_modes_give_equal_gradients(arch):
    """none, dots and full: the same loss and gradients bit for bit (the
    same ops on the same inputs); dots recomputes the blocks but none of
    their 2-D products: its backward runs fewer products than full's, as
    many as none's."""
    base = build_model(smoke_config(arch))
    w = base.init(0, device="cpu", dtype=torch.float32)
    batch = SyntheticTask(base.cfg, batch=4, seq_len=32, seed=2).batch_at(0)
    out = {}
    for remat in ("none", "dots", "full"):
        m = build_model(smoke_config(arch).replace(remat=remat))
        p = tree_map(lambda t: t.detach().clone().requires_grad_(True), w)
        loss, _ = m.loss(p, batch)
        mode = _MMs()
        with mode:
            g = torch.autograd.grad(loss, tree_leaves(p))
        out[remat] = (loss.detach(), g, mode.n)
    for remat in ("none", "dots"):
        assert torch.equal(out[remat][0], out["full"][0]), remat
        assert all(torch.equal(a, b) for a, b in zip(out[remat][1],
                                                     out["full"][1])), remat
    assert out["dots"][2] == out["none"][2] < out["full"][2], \
        {k: v[2] for k, v in out.items()}


@pytest.mark.parametrize("arch", ["qwen3-1.7b", MOE])
def test_remat_dots_matches_reference(arch):
    cfg, jcfg = _cfg(arch, remat="dots")
    tree = _weights(arch)
    batch = _batch(cfg)
    jloss, jmet, jgrads = _reference_loss(jcfg, tree, batch)
    model = build_model(cfg)
    params = _torch_params(model, tree)
    loss, met = model.loss(params, batch)
    grads = iter(torch.autograd.grad(loss, tree_leaves(params)))
    _assert_close(float(loss.detach()), jloss, "loss")
    assert float(met["aux"].detach()) == pytest.approx(jmet["aux"], rel=LOSS_REL)
    _assert_grads(jgrads, tree_map(lambda _: next(grads), params), arch)


def _history_close(got, want, what):
    """Losses and learning rates within STEPS_REL, gradient norms within
    GRAD_REL."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for key, rel in (("loss", STEPS_REL), ("lr", STEPS_REL),
                         ("grad_norm", GRAD_REL)):
            assert a[key] == pytest.approx(b[key], rel=rel), \
                (what, a["step"], key, a[key], b[key])


@pytest.mark.parametrize("arch", ARCHS)
def test_five_trainer_steps_match_reference(arch):
    """Five ``Trainer`` steps against the reference's ``Trainer`` (A13b's
    gate: the loss curves): losses and learning rates within STEPS_REL,
    gradient norms within GRAD_REL, the gradients' own limit.  A norm is
    as close as its gradient: arctic has no QK-norm, and its attention's
    and embedding's gradients sit at 3e-5 of their largest (as qwen2-7b's
    do in tests/test_torch_train.py), which moves its norm by 1.0e-5 at
    the port's own step-2 params (traced: the port's forward routes every
    token as on the reference's params, and its gradient on those is the
    reference's within GRAD_REL)."""
    tree = _weights(arch)
    cfg, jcfg = _cfg(arch)
    jm = jax_build_model(jcfg)
    jopt = JO.AdamWConfig(peak_lr=1e-3, warmup_steps=1, decay_steps=5)
    jtr = JTrainer(jm, jopt, JTrainerConfig(steps=5, log_every=100),
                   jdata_iter(JTask(jcfg, batch=B, seq_len=S, seed=2)),
                   log=lambda s: None)
    jp = jax.tree.map(jnp.asarray, tree)
    jtr._initialize = lambda: ({"params": jp,
                                "opt": JO.adamw_init(jp, jopt)}, 5)
    want = jtr.fit()["history"]
    model = build_model(cfg)
    tr = Trainer(model, PO.AdamWConfig(peak_lr=1e-3, warmup_steps=1,
                                       decay_steps=5),
                 TrainerConfig(steps=5, log_every=100),
                 make_data_iter(SyntheticTask(cfg, batch=B, seq_len=S,
                                              seed=2), device="cpu"),
                 device="cpu", params=_torch_params(model, tree),
                 log=lambda s: None)
    _history_close(tr.fit()["history"], want, arch)


def test_bf16_moments_step_matches_reference():
    """One step with bf16 moments (qwen3-moe's declared ``moment_dtype``):
    the loss and norm, and each moment leaf, bf16, against the
    reference's ``AdamWConfig(moment_dtype=bfloat16)``."""
    tree = _weights(MOE)
    cfg, jcfg = _cfg(MOE)
    batch = _batch(cfg)
    kw = dict(peak_lr=1e-2, warmup_steps=0, decay_steps=10)
    jopt = JO.AdamWConfig(moment_dtype=jnp.bfloat16, **kw)
    jm = jax_build_model(jcfg)
    jp = jax.tree.map(jnp.asarray, tree)
    loss_fn = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, _jbatch(batch), None)[0]))
    jloss, jg = loss_fn(jp)
    _, jo, jstats = jax.jit(lambda p, g, o: JO.adamw_update(p, g, o, jopt))(
        jp, jg, JO.adamw_init(jp, jopt))
    model = build_model(cfg)
    opt = PO.AdamWConfig(moment_dtype=torch.bfloat16, **kw)
    state = create_train_state(model, 0, opt, device="cpu",
                               params=_torch_params(model, tree))
    _, m = make_train_step(model, opt)(state, batch)
    _assert_close(float(m["loss"]), float(jloss), "loss")
    assert float(m["grad_norm"]) == pytest.approx(
        float(jstats["grad_norm"]), rel=STEPS_REL)
    for key in ("m", "v"):
        for path, want, got in _walk(jo[key], state["opt"][key]):
            assert got.dtype == torch.bfloat16, path
            want = want.astype(np.float32)
            err = float(np.abs(got.float().numpy() - want).max())
            assert err <= MOMENT_BF16_REL * float(np.abs(want).max()), \
                (key, path, err)


# -- over a mesh --------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_weights():
    """Seeded SMOKE weights of the mesh runs (the port's init)."""
    return tree_map(lambda t: t.numpy(), R.moe_train_model().init(
        0, device="cpu", dtype=torch.float32))


@pytest.fixture(scope="module")
def worlds(mesh_weights, tmp_path_factory):
    """world -> every rank's :func:`_torch_ranks.moe_train` results."""
    return {n: C.run_ranks(R.moe_train, (mesh_weights,), world=n,
                           store_dir=tmp_path_factory.mktemp(f"moe{n}"),
                           device="cpu", timeout=600)
            for n in (2, 4)}


def _composed_loss(jm, p, batch, dp):
    """The reference's loss composed per data block: ce over the whole
    batch, aux the mean over the ``dp`` data blocks of each block's."""
    _, met = jm.loss(p, batch, None)
    per = R.TRAIN_B // dp
    aux = sum(jm.loss(p, {k: v[i * per:(i + 1) * per]
                          for k, v in batch.items()}, None)[1]["aux"]
              for i in range(dp)) / dp
    return met["ce"] + jm.cfg.moe_aux_weight * aux, \
        {"ce": met["ce"], "aux": aux}


@pytest.fixture(scope="module")
def composed(mesh_weights):
    """dp -> the composed reference's first step (loss, metrics, grads)
    and its five AdamW steps (the trainer's schedule)."""
    jm = jax_build_model(jax_smoke_config(R.MOE_ARCH).replace(
        remat="none", tp=2, capacity_factor=R.MOE_TRAIN_CF))
    task = R.train_task(R.moe_train_model().cfg)
    opt = JO.AdamWConfig(**R.TRAIN_OPT5)
    update = jax.jit(lambda p, g, o: JO.adamw_update(p, g, o, opt))
    out = {}
    for dp in (1, 2):
        vg = jax.jit(jax.value_and_grad(
            lambda p, b: _composed_loss(jm, p, b, dp), has_aux=True))
        params = jax.tree.map(jnp.asarray, mesh_weights)
        ost = JO.adamw_init(params, opt)
        hist = []
        for i in range(5):
            (loss, met), g = vg(params, _jbatch(task.batch_at(i)))
            if i == 0:
                out[dp, "step"] = (float(loss), {k: float(v) for k, v in
                                                 met.items()}, g)
            params, ost, st = update(params, g, ost)
            hist.append({"step": i + 1, "loss": float(loss),
                         "grad_norm": float(st["grad_norm"]),
                         "lr": float(st["lr"])})
        out[dp, "history"] = hist
    return out


@pytest.mark.parametrize("n,shape", MESHES, ids=MESH_IDS)
def test_mesh_step_matches_composed_reference(worlds, composed, n, shape):
    loss, met, grads = composed[shape[0], "step"]
    res = [r[shape]["step"] for r in worlds[n]]
    for r in res:
        _assert_close(r["loss"], loss, "loss")
        for key in ("ce", "aux"):
            _assert_close(r[key], met[key], key)
        assert r["loss"] == res[0]["loss"]
    _assert_grads(grads, res[0]["grads"], f"mesh {shape}")


@pytest.mark.parametrize("n,shape", MESHES, ids=MESH_IDS)
def test_mesh_five_trainer_steps(worlds, composed, n, shape):
    for r in worlds[n]:
        _history_close(r[shape]["history"], composed[shape[0], "history"],
                       f"mesh {shape}")


@pytest.mark.parametrize("n,shape", MESHES, ids=MESH_IDS)
def test_mesh_sharded_init_gathers_bit_for_bit(worlds, n, shape):
    """The state drawn leaf by leaf on the mesh, the expert stacks cut over
    "model" and "data", gathers back to the unsharded state."""
    whole = create_train_state(R.moe_train_model(), 0, PO.AdamWConfig(),
                               device="cpu")["params"]
    got = worlds[n][0][shape]["init"]
    for path, want, leaf in _walk(tree_map(lambda t: t.detach().numpy(),
                                           whole), got):
        np.testing.assert_array_equal(leaf, want, err_msg=str(path))


@pytest.mark.parametrize("n,shape", MESHES, ids=MESH_IDS)
def test_mesh_block_matches_serial_per_rank(worlds, mesh_weights, n, shape):
    """Layer 0's block at the config's capacity factor, each rank routing
    its own MOE_BLOCK_T tokens against its E/tp experts: its output is the
    reference's serial block on that rank's tokens (dropped assignments
    included), its aux the reference's on the tokens of its data block
    (the ranks of its "model" group, in order)."""
    _, jcfg = _cfg(R.MOE_ARCH, tp=2)
    w = {k: jnp.asarray(v[0]) for k, v in
         mesh_weights["blocks"]["moe"].items()}
    dp, tp = shape
    dropped = 0
    for rank, r in enumerate(worlds[n]):
        got = r[shape]["block"]
        x = R.moe_block_tokens(rank, jcfg.d_model)
        jy, _, jstats = _jblock(jcfg)(jnp.asarray(x), w["router"],
                                      w["gate"], w["up"], w["down"])
        jy = np.asarray(jy)
        err = float(np.abs(got["y"].numpy() - jy).max())
        assert err <= BLOCK_REL * float(np.abs(jy).max()), (rank, err)
        np.testing.assert_array_equal(got["dropped"].numpy(),
                                      np.asarray(jstats["dropped"]))
        dropped += int(got["dropped"].sum())
        group = [rank // tp * tp + m for m in range(tp)]
        xs = np.concatenate([R.moe_block_tokens(g, jcfg.d_model)
                             for g in group])
        _, jaux, _ = _jblock(jcfg)(jnp.asarray(xs), w["router"],
                                   w["gate"], w["up"], w["down"])
        _assert_close(got["aux"], float(jaux), "block aux")
    assert dropped > 0
