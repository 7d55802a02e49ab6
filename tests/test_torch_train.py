"""One-card training of the port (ROADMAP A13a) against the reference's, on
the CPU, from bridged SMOKE weights and the same synthetic batches:

* ``lm_loss`` and every leaf's gradient against ``jax.value_and_grad`` of
  the reference's loss (qwen3-1.7b with QK-norm, qwen2-7b with QKV bias,
  gemma3-4b with its sliding-window layers); ``remat`` none against full;
* ``adamw_update`` leaf by leaf, ``lr_schedule``;
* five ``Trainer`` steps' losses and gradient norms; ``accum_steps`` 2
  against 1 and against the reference's 2;
* checkpoints written by either package restored by the other, the
  corrupted-checkpoint fallback and ``NanGuard``'s rollback;
* what is refused: MoE and VLM training, ``remat='dots'``, compressed
  gradient sync outside pod-DP, a mesh wider than the visible cards
  (training over a mesh itself: tests/test_torch_mesh_train.py).

Tolerances: float32 on both sides, summation order only.  The loss within
1e-6 of its value; each gradient leaf within 1e-4 of its largest
magnitude (qwen2-7b's attention gradients, whose scores have no QK-norm,
sit furthest: 4.5e-5 of wq's); AdamW's params and moments within 1e-6 of
theirs (XLA may fuse a multiply-add the port rounds twice); five trainer
steps' losses and gradient norms within 1e-5 (Adam's update divides each
gradient by its own root mean square, so its rounding gaps stay at the
gradients' relative size).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.data import SyntheticTask as JTask, make_data_iter as jdata_iter
from repro.models.api import build_model as jax_build_model
from repro.optim import adamw as JO
from repro.train import (NanGuard as JNanGuard, Trainer as JTrainer,
                         TrainerConfig as JTrainerConfig)
from repro.train import checkpoint as jckpt
from repro.train.step import make_train_step as jmake_train_step
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import smoke_config
from repro_torch.data import SyntheticTask, make_data_iter
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.models.api import build_model
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.optim import adamw as PO
from repro_torch.train import (NanGuard, Trainer, TrainerConfig,
                               create_train_state, make_eval_step,
                               make_train_step)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.fault import reshard_state, restore_latest_valid

LOSS_REL, GRAD_REL, ADAM_TOL, STEPS_REL = 1e-6, 1e-4, 1e-6, 1e-5
B, S = 4, 32


def _sorted_leaves(tree) -> list:
    """A nested dict's leaves in sorted-key order (jax.tree.leaves')."""
    return [t for _, t in ckpt._leaves(tree)]


def _pair(arch, seed=0):
    """(reference model, its params, port model, bridged numpy tree)."""
    jmodel = jax_build_model(jax_smoke_config(arch))
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(
        lambda a: (np.asarray(a) + 0.02 * rng.normal(size=a.shape))
        .astype(np.float32), jmodel.init(jax.random.PRNGKey(0)))
    return jmodel, jax.tree.map(jnp.asarray, tree), \
        build_model(smoke_config(arch)), tree


def _torch_params(model, tree):
    params = params_from_numpy(tree, device="cpu", defs=model.param_defs())
    return tree_map(lambda t: t.requires_grad_(True), params)


def _batch(cfg, step=0):
    b = SyntheticTask(cfg, batch=B, seq_len=S, seed=2).batch_at(step)
    b["labels"][0, :3] = -1                        # unscored positions too
    return b


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen2-7b", "gemma3-4b"])
def test_loss_and_grads_match_reference(arch):
    jmodel, jp, model, tree = _pair(arch)
    batch = _batch(model.cfg)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, None), has_aux=True)(jp)
    params = _torch_params(model, tree)
    loss, met = model.loss(params, batch)
    loss.backward()
    assert float(met["tokens"]) == float(jmet["tokens"]) == B * S - 3
    assert float(met["aux"]) == 0.0
    assert abs(float(loss) - float(jloss)) <= LOSS_REL * abs(float(jloss))
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    for path, jg in flat:
        t = params
        for key in path:
            t = t[key.key]
        want = np.asarray(jg)
        err = float(np.abs(t.grad.numpy() - want).max())
        limit = GRAD_REL * float(np.abs(want).max())
        assert err <= limit, (f"{arch} {jax.tree_util.keystr(path)}: max "
                              f"abs err {err} > {limit}")


def test_remat_none_equals_full():
    """Recomputing every block in the backward pass changes no gradient
    (the same ops on the same inputs, CPU)."""
    _, _, model, tree = _pair("qwen3-1.7b")
    batch = _batch(model.cfg)
    grads = []
    for remat in ("full", "none"):
        m = build_model(smoke_config("qwen3-1.7b").replace(remat=remat))
        params = _torch_params(m, tree)
        m.loss(params, batch)[0].backward()
        grads.append([t.grad for t in tree_leaves(params)])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_cross_entropy_matches_reference():
    from repro.models import layers as JL
    from repro_torch.models import layers as L
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 5, 40)).astype(np.float32) * 3
    labels = rng.integers(-1, 30, (2, 5)).astype(np.int32)
    for kw in ({}, {"true_vocab": 30, "z_loss": 1e-3}):
        want = float(JL.cross_entropy(jnp.asarray(logits),
                                      jnp.asarray(labels), **kw))
        got = float(L.cross_entropy(torch.from_numpy(logits),
                                    torch.from_numpy(labels), **kw))
        assert abs(got - want) <= 1e-6 * abs(want), (kw, got, want)


def test_adamw_update_and_schedule_match_reference():
    rng = np.random.default_rng(1)
    kw = dict(peak_lr=1e-2, warmup_steps=3, decay_steps=12)
    jcfg, cfg = JO.AdamWConfig(**kw), PO.AdamWConfig(**kw)
    for step in (0, 1, 2, 3, 4, 7, 12, 30):
        assert float(PO.lr_schedule(cfg, step)) == pytest.approx(
            float(JO.lr_schedule(jcfg, step)), rel=1e-7, abs=0)
    p = {"w": rng.normal(size=(6, 4)).astype(np.float32),
         "n": {"scale": (1 + rng.normal(size=4)).astype(np.float32)}}
    jp = jax.tree.map(jnp.asarray, p)
    tp = tree_map(torch.tensor, p)
    jo, to = JO.adamw_init(jp, jcfg), PO.adamw_init(tp, cfg)
    for i in range(5):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * (i + 1))
                         .astype(np.float32), p)
        jp, jo, js = JO.adamw_update(jp, jax.tree.map(jnp.asarray, g), jo,
                                     jcfg)
        tp, to, ts = PO.adamw_update(tp, tree_map(torch.tensor, g), to, cfg)
        assert int(to["step"]) == int(jo["step"]) == i + 1
        for name, want, got in (("grad_norm", js["grad_norm"],
                                 ts["grad_norm"]), ("lr", js["lr"],
                                                    ts["lr"])):
            assert float(got) == pytest.approx(float(want), rel=1e-6), name
        for jt, tt in ((jp, tp), (jo["m"], to["m"]), (jo["v"], to["v"])):
            for a, b in zip(jax.tree.leaves(jt), _sorted_leaves(tt)):
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           rtol=ADAM_TOL, atol=ADAM_TOL)


def _reference_run(arch, tree, steps):
    jmodel = jax_build_model(jax_smoke_config(arch))
    opt = JO.AdamWConfig(peak_lr=1e-3, warmup_steps=1, decay_steps=steps)
    tcfg = JTrainerConfig(steps=steps, log_every=100)
    tr = JTrainer(jmodel, opt, tcfg,
                  jdata_iter(JTask(jmodel.cfg, batch=B, seq_len=S, seed=2)),
                  log=lambda s: None)
    # the bridged weights, in place of the trainer's own init
    tr._initialize = lambda: ({"params": jax.tree.map(jnp.asarray, tree),
                               "opt": JO.adamw_init(jax.tree.map(
                                   jnp.asarray, tree), opt)}, steps)
    return tr.fit()["history"]


def _port_run(arch, tree, steps, ckpt_dir=None):
    model = build_model(smoke_config(arch))
    opt = PO.AdamWConfig(peak_lr=1e-3, warmup_steps=1, decay_steps=steps)
    tcfg = TrainerConfig(steps=steps, log_every=100, ckpt_dir=ckpt_dir,
                         ckpt_every=2)
    tr = Trainer(model, opt, tcfg,
                 make_data_iter(SyntheticTask(model.cfg, batch=B, seq_len=S,
                                              seed=2), device="cpu"),
                 device="cpu", params=_torch_params(model, tree),
                 log=lambda s: None)
    return tr.fit()["history"], tr


def _same_history(got, want, what):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for key in ("loss", "grad_norm", "lr"):
            assert a[key] == pytest.approx(b[key], rel=STEPS_REL), \
                (what, a["step"], key, a[key], b[key])


def test_five_trainer_steps_match_reference():
    _, _, _, tree = _pair("qwen3-1.7b")
    want = _reference_run("qwen3-1.7b", tree, 5)
    got, tr = _port_run("qwen3-1.7b", tree, 5)
    _same_history(got, want, "5 trainer steps")
    assert tr.stragglers == [] or all(s >= 5 for s in tr.stragglers)


def test_accum_steps_two_against_one_and_reference():
    """Two microbatches of 2 rows: the loss is their mean and the update
    that of the whole batch within rounding; the reference's accumulated
    step the same."""
    _, _, model, tree = _pair("qwen3-1.7b")
    batch = _batch(model.cfg)
    opt = PO.AdamWConfig(peak_lr=1e-3, warmup_steps=1, decay_steps=5)
    runs = {}
    for accum in (1, 2):
        state = create_train_state(model, 0, opt, device="cpu",
                                   params=_torch_params(model, tree))
        step = make_train_step(model, opt, accum_steps=accum)
        _, m = step(state, batch)
        runs[accum] = (state, m)
    (s1, m1), (s2, m2) = runs[1], runs[2]
    # the batch's mean loss is the microbatches' mean (each scores 64 or
    # 61 tokens: equal up to that weighting)
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=2e-2)
    assert float(m2["grad_norm"]) == pytest.approx(float(m1["grad_norm"]),
                                                   rel=5e-2)
    jmodel = jax_build_model(jax_smoke_config("qwen3-1.7b"))
    jopt = JO.AdamWConfig(peak_lr=1e-3, warmup_steps=1, decay_steps=5)
    jp = jax.tree.map(jnp.asarray, tree)
    jstep = jmake_train_step(jmodel, jopt, accum_steps=2, donate=False)
    jstate, jm = jstep({"params": jp, "opt": JO.adamw_init(jp, jopt)},
                       {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    assert float(m2["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-6)
    assert float(m2["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-5)
    # the first moments are 0.1 x the clipped accumulated gradients: held
    # leaf by leaf as the gradients are (a first Adam step moves a weight
    # by about lr whatever its gradient's size, so a near-zero gradient's
    # sign, which rounding decides, moves it by 2 lr: the params are not
    # compared)
    for a, b in zip(jax.tree.leaves(jstate["opt"]["m"]),
                    _sorted_leaves(s2["opt"]["m"])):
        want = np.asarray(a)
        err = float(np.abs(b.numpy() - want).max())
        assert err <= GRAD_REL * float(np.abs(want).max()), err


def test_checkpoints_cross_restore(tmp_path):
    """The port's trainer checkpoints at steps 2 and 3; a reference state
    (the bridged params, a step's moments) is saved by the reference at the
    same steps.  Each directory restores into the other package's state,
    leaf for leaf bit for bit; the manifests name the same leaves."""
    _, _, model, tree = _pair("qwen3-1.7b")
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    _, ttr = _port_run("qwen3-1.7b", tree, 3, ckpt_dir=tdir)
    jp = jax.tree.map(jnp.asarray, tree)
    jopt = JO.adamw_init(jp, JO.AdamWConfig())
    jopt["m"] = jax.tree.map(lambda a: a * 0.5, jp)
    jopt["step"] = jnp.asarray(3, jnp.int32)
    jstate = {"params": jp, "opt": jopt}
    for step in (2, 3):
        jckpt.save_checkpoint(jdir, step, jstate)
    assert ckpt.checkpoint_steps(tdir) == jckpt.checkpoint_steps(jdir) \
        == [2, 3]
    for d in (jdir, tdir):
        with open(os.path.join(d, "step_00000003", "manifest.json")) as f:
            names = sorted(json.load(f)["leaves"])
        assert "params____blocks____attn____wq" in names
        assert "opt____step" in names
    tnames = sorted(json.load(open(os.path.join(
        tdir, "step_00000003", "manifest.json")))["leaves"])
    jnames = sorted(json.load(open(os.path.join(
        jdir, "step_00000003", "manifest.json")))["leaves"])
    assert tnames == jnames
    # reference -> port
    like = create_train_state(model, 0, PO.AdamWConfig(), device="cpu")
    got, step = ckpt.restore_checkpoint(jdir, like)
    assert step == 3 and got["params"]["embed"]["table"].requires_grad
    for a, b in zip(jax.tree.leaves(jstate), _sorted_leaves(got)):
        np.testing.assert_array_equal(b.detach().numpy(), np.asarray(a))
    # port -> reference
    jlike = jax.tree.map(lambda a: jnp.zeros_like(a), jstate)
    jgot, jstep = jckpt.restore_checkpoint(tdir, jlike)
    assert jstep == 3
    for a, b in zip(jax.tree.leaves(jgot), _sorted_leaves(ttr.final_state)):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())


def test_corrupted_checkpoint_falls_back_and_nan_guard_rolls_back(tmp_path):
    _, _, model, tree = _pair("qwen3-1.7b")
    opt = PO.AdamWConfig()
    state = create_train_state(model, 0, opt, device="cpu",
                               params=_torch_params(model, tree))
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 1, state)
    with torch.no_grad():
        for t in tree_leaves(state["params"]):
            t.add_(1.0)
    ckpt.save_checkpoint(d, 2, state)
    leaf = os.path.join(d, "step_00000002", "params____final_norm____scale"
                        ".npy")
    arr = np.load(leaf)
    np.save(leaf, arr + 1)                            # a flipped leaf
    with pytest.raises(ValueError, match="corrupted"):
        ckpt.restore_checkpoint(d, state, step=2)
    restored, step = restore_latest_valid(d, state)
    assert step == 1
    np.testing.assert_array_equal(
        restored["params"]["final_norm"]["scale"].detach().numpy(),
        tree["final_norm"]["scale"])
    guard = NanGuard(d, max_rollbacks=1)
    assert guard.check(torch.tensor(2.5), state) is None
    rolled = guard.check(torch.tensor(float("nan")), state)
    assert rolled is not None and rolled[1] == 1 and rolled[2] == 1
    with pytest.raises(FloatingPointError):
        guard.check(torch.tensor(float("inf")), state)
    jguard = JNanGuard(d, max_rollbacks=1)         # the reference agrees
    assert jguard.check(jnp.float32(2.5), None) is None
    # a whole state resharded onto no mesh: an equal copy, nothing shared
    again = reshard_state(state, None)
    for a, b in zip(tree_leaves(again), tree_leaves(state)):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
        assert a.requires_grad == b.requires_grad


def test_eval_step_and_refusals():
    _, _, model, tree = _pair("qwen3-1.7b")
    params = _torch_params(model, tree)
    batch = _batch(model.cfg)
    out = make_eval_step(model)(params, batch)
    assert out["loss"].grad_fn is None and float(out["tokens"]) == B * S - 3
    with pytest.raises(ValueError, match="pod_dp"):
        make_train_step(model, PO.AdamWConfig(), grad_sync="compressed")
    with pytest.raises(NotImplementedError, match="A13b"):
        build_model(smoke_config("qwen3-1.7b").replace(remat="dots")).loss(
            params, batch)
    moe = build_model(smoke_config("qwen3-moe-235b-a22b"))
    with pytest.raises(NotImplementedError, match="A13b"):
        T.lm_loss({}, moe.cfg, tokens=batch["tokens"],
                  labels=batch["labels"])
    vlm = build_model(smoke_config("llava-next-mistral-7b"))
    with pytest.raises(NotImplementedError, match="A13b"):
        vlm.loss({}, batch)
    # a mesh wider than the visible cards: run_ranks refuses, no fallback
    if torch.cuda.device_count() < 8:
        with pytest.raises(RuntimeError, match="8 NCCL ranks need 8 CUDA"):
            launch_train.main(["--smoke", "--device", "cuda", "--mesh",
                               "debug"])
    specs = model.train_batch_specs(type("S", (), {"global_batch": 2,
                                                   "seq_len": 8})())
    assert specs["tokens"].shape == (2, 8) and "labels" in specs
    assert "labels" not in model.prefill_batch_specs(
        type("S", (), {"global_batch": 2, "seq_len": 8})())


def test_launcher_summary_line(capsys):
    res = launch_train.main(["--smoke", "--device", "cpu", "--steps", "2",
                             "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    h = res["history"]
    assert (f"[train] qwen3-1.7b: loss {h[0]['loss']:.4f} -> "
            f"{h[-1]['loss']:.4f} over 2 steps; stragglers=[]") in out
    assert "rmsnorm: launches=0 plain=" in out
