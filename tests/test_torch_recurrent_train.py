"""One-device training of the recurrent families (rwkv6 and zamba2, ROADMAP
A13b item 4) against the reference's, on the CPU, from bridged SMOKE
weights and the same synthetic batches:

* the loss and every gradient leaf against ``jax.value_and_grad`` of the
  reference's ``model.loss``: rwkv6 at S 32 (the reference's chunked wkv,
  ``rwkv_time_chunk`` 32) and at S 24 (its per-step scan); zamba2 at S 32,
  where the shared block runs twice and its one copy sums both
  applications' gradients;
* five ``Trainer`` steps of each family against the reference's
  ``Trainer``;
* the plain versions the card's backward kernels are held to
  (``rwkv6_scan_plain``, ``ssd_scan_plain``, ``gated_rmsnorm_plain``)
  differentiated by autograd against ``jax.grad`` of the reference's
  ``_wkv_chunked``, ``_ssd_chunked`` and gated norm.

Training over a mesh (item 4b) is tests/test_torch_recurrent_mesh.py's.

Tolerances are tests/test_torch_train.py's (float32 on both sides,
summation order only): the loss within 1e-6 of its value, each gradient
leaf within 1e-4 of its largest magnitude, five trainer steps' losses and
gradient norms within 1e-5; the reference computes the wkv in its chunked
log-decay form and the SSD in its chunked dual form where the port steps
the recurrences, so the plain versions' gradients are held within 1e-4 of
each leaf's largest magnitude as well.  zamba2 SMOKE is less well
conditioned, the reference as much as the port: its small embedding rows
(~0.02) go straight into an RMSNorm, so the table's and conv_x's
gradients dominate (norms 16.7 and 13.4 of 22.5), and a first Adam step
moves each entry of the table by ~5% of its size.  Its float32 gradients,
the reference's and the port's alike, lie up to 1.3e-4 of a leaf's
largest magnitude from a float64 run of the port (A_log, w_x) and 1.15e-4
from each other (w_x): the leaves are held within 3e-4.  Its
trainer steps after the first amplify that (a near-zero gradient's sign,
which rounding decides, moves its weight by 2 lr): the float64 port's
gradient norm drifted 7% from the reference's by step 5 on another
draw of the weights, the float32 port's 1-3%, while the losses stayed
within 1.1e-4 (float32: 7.5e-5).  So
zamba2's five steps are held to losses within 2e-4 and the first step's
gradient norm within 1e-4 (its leaves' limit; measured 1.1e-5); the later
gradient norms, which no float32 run reproduces, are held finite only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.data import SyntheticTask as JTask, make_data_iter as jdata_iter
from repro.models import layers as JL
from repro.models.api import build_model as jax_build_model
from repro.models.mamba2 import _ssd_chunked
from repro.models.rwkv6 import _wkv_chunked
from repro.optim import adamw as JO
from repro.train import Trainer as JTrainer, TrainerConfig as JTrainerConfig
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import smoke_config
from repro_torch.data import SyntheticTask, make_data_iter
from repro_torch.kernels.rmsnorm import gated_rmsnorm_plain
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.models.api import build_model
from repro_torch.models.module import tree_map
from repro_torch.optim import adamw as PO
from repro_torch.train import Trainer, TrainerConfig

LOSS_REL, PLAIN_REL = 1e-6, 1e-4
GRAD_REL = {"rwkv6-3b": 1e-4, "zamba2-7b": 3e-4}
# (loss, first step's gradient norm, later gradient norms; None: finite)
# of five steps
STEPS_REL = {"rwkv6-3b": (1e-5, 1e-5, 1e-5), "zamba2-7b": (2e-4, 1e-4, None)}
B = 4
ARCHS = ("rwkv6-3b", "zamba2-7b")


def _tree(arch):
    """(the reference model, SMOKE weights as numpy float32): the port's
    seeded init (the reference's tree, leaf for leaf; the reference's own
    init costs seconds of compilation) nudged off its zeros and ones by
    seeded noise (decay bases, biases)."""
    init = build_model(smoke_config(arch)).init(0, device="cpu",
                                                dtype=torch.float32)
    rng = np.random.default_rng(0)
    return jax_build_model(jax_smoke_config(arch)), tree_map(
        lambda t: (t.numpy() + 0.02 * rng.normal(size=t.shape))
        .astype(np.float32), init)


def _torch_params(model, tree):
    params = params_from_numpy(tree, device="cpu", defs=model.param_defs())
    return tree_map(lambda t: t.requires_grad_(True), params)


def _batch(cfg, S):
    b = SyntheticTask(cfg, batch=B, seq_len=S, seed=2).batch_at(0)
    b["labels"][0, :3] = -1                        # unscored positions too
    return b


@pytest.fixture(scope="module")
def reference():
    """Each family's reference model and bridged tree, made once, and its
    losses and gradients by (arch, S), computed once each."""
    pairs = {arch: _tree(arch) for arch in ARCHS}
    grads = {}

    def get(arch, S):
        if (arch, S) not in grads:
            jmodel, tree = pairs[arch]
            batch = _batch(build_model(smoke_config(arch)).cfg, S)
            jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
            (jloss, jmet), jg = jax.value_and_grad(
                lambda p: jmodel.loss(p, jbatch, None), has_aux=True)(
                jax.tree.map(jnp.asarray, tree))
            grads[arch, S] = (batch, float(jloss), float(jmet["tokens"]), jg)
        return grads[arch, S]

    return pairs, get


@pytest.mark.parametrize("arch,S", [("rwkv6-3b", 32), ("rwkv6-3b", 24),
                                    ("zamba2-7b", 32)])
def test_loss_and_grads_match_reference(reference, arch, S):
    pairs, get = reference
    batch, jloss, jtokens, jgrads = get(arch, S)
    model = build_model(smoke_config(arch))
    if arch == "zamba2-7b":
        cfg = model.cfg
        assert cfg.n_layers // cfg.shared_attn_every == 2   # two applications
    params = _torch_params(model, pairs[arch][1])
    loss, met = model.loss(params, batch)
    loss.backward()
    assert float(met["tokens"]) == jtokens == B * S - 3
    assert abs(loss.item() - jloss) <= LOSS_REL * abs(jloss)
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat) == len(jax.tree.leaves(pairs[arch][1]))
    for path, jg in flat:
        t = params
        for key in path:
            t = t[key.key]
        want = np.asarray(jg)
        err = float(np.abs(t.grad.numpy() - want).max())
        limit = GRAD_REL[arch] * float(np.abs(want).max())
        assert err <= limit, (f"{arch} S={S} {jax.tree_util.keystr(path)}: "
                              f"max abs err {err} > {limit}")


@pytest.mark.parametrize("arch", ARCHS)
def test_five_trainer_steps_match_reference(reference, arch):
    pairs, _ = reference
    jmodel, tree = pairs[arch]
    steps, S = 5, 32
    jopt = JO.AdamWConfig(peak_lr=1e-3, warmup_steps=1, decay_steps=steps)
    jtr = JTrainer(jmodel, jopt, JTrainerConfig(steps=steps, log_every=100),
                   jdata_iter(JTask(jmodel.cfg, batch=B, seq_len=S, seed=2)),
                   log=lambda s: None)
    jp = jax.tree.map(jnp.asarray, tree)
    jtr._initialize = lambda: ({"params": jp,
                                "opt": JO.adamw_init(jp, jopt)}, steps)
    want = jtr.fit()["history"]
    model = build_model(smoke_config(arch))
    opt = PO.AdamWConfig(peak_lr=1e-3, warmup_steps=1, decay_steps=steps)
    tr = Trainer(model, opt, TrainerConfig(steps=steps, log_every=100),
                 make_data_iter(SyntheticTask(model.cfg, batch=B, seq_len=S,
                                              seed=2), device="cpu"),
                 device="cpu", params=_torch_params(model, tree),
                 log=lambda s: None)
    got = tr.fit()["history"]
    assert len(got) == len(want) == steps
    assert got[-1]["loss"] < got[0]["loss"]
    loss_rel, first_rel, later_rel = STEPS_REL[arch]
    for a, b in zip(got, want):
        assert a["lr"] == pytest.approx(b["lr"], rel=1e-6)
        assert np.isfinite(a["grad_norm"])
        for key, rel in (("loss", loss_rel), ("grad_norm", first_rel
                                              if a["step"] == 1
                                              else later_rel)):
            if rel is not None:
                assert a[key] == pytest.approx(b[key], rel=rel), \
                    (arch, a["step"], key, a[key], b[key])


def _grads_close(what, got, want):
    for name, g, w in zip(what, got, want):
        w = np.asarray(w)
        err = float(np.abs(g.detach().numpy() - w).max())
        assert err <= PLAIN_REL * float(np.abs(w).max()), (name, err)


def test_wkv_plain_gradients_match_reference_chunked():
    """rwkv6_scan_plain under autograd against jax.grad of the reference's
    chunked wkv (SMOKE widths: H 4, K = V = 16, two chunks of 32), with a
    nonzero initial state and cotangents on y and the final state."""
    rng = np.random.default_rng(1)
    Bs, S, H, K = 2, 64, 4, 16
    f = np.float32
    r, k, v = (rng.normal(size=(Bs, S, H, K)).astype(f) for _ in range(3))
    w = np.exp(-np.exp(rng.normal(-1.5, 0.5, (Bs, S, H, K)))).astype(f)
    u = rng.normal(size=(H, K)).astype(f)
    s0 = rng.normal(size=(Bs, H, K, K)).astype(f)
    gy = rng.normal(size=(Bs, S, H, K)).astype(f)
    gs = rng.normal(size=(Bs, H, K, K)).astype(f)
    ins = (r, k, v, w, u, s0)

    def jfn(*a):
        y, st = _wkv_chunked(*a, chunk=32)
        return jnp.sum(y * gy) + jnp.sum(st * gs)

    want = jax.grad(jfn, argnums=tuple(range(6)))(*map(jnp.asarray, ins))
    leaves = [torch.tensor(a, requires_grad=True) for a in ins]
    y, st = rwkv6_scan_plain(*leaves)
    got = torch.autograd.grad(
        (y * torch.from_numpy(gy)).sum() + (st * torch.from_numpy(gs)).sum(),
        leaves)
    _grads_close(("r", "k", "v", "w", "u", "state0"), got, want)


def test_ssd_plain_gradients_match_reference_chunked():
    """ssd_scan_plain under autograd, fed the reference's xdt and log
    decay, against jax.grad of the reference's chunked SSD (SMOKE widths: H
    8, P 16, N 8, chunks of 16) with respect to its inputs x, dt, a, B, C
    and the initial state."""
    rng = np.random.default_rng(2)
    Bs, S, H, P, N = 2, 32, 8, 16, 8
    f = np.float32
    xh = rng.normal(size=(Bs, S, H, P)).astype(f)
    dt = np.log1p(np.exp(rng.normal(size=(Bs, S, H)))).astype(f)
    a = np.exp(-dt).astype(f)
    bm, cm = (rng.normal(size=(Bs, S, N)).astype(f) for _ in range(2))
    s0 = rng.normal(size=(Bs, H, N, P)).astype(f)
    gy = rng.normal(size=(Bs, S, H, P)).astype(f)
    gs = rng.normal(size=(Bs, H, N, P)).astype(f)
    ins = (xh, dt, a, bm, cm, s0)

    def jfn(xh, dt, a, bm, cm, s0):
        y, st = _ssd_chunked(xh, dt, a, bm, cm, 16, state0=s0)
        return jnp.sum(y * gy) + jnp.sum(st * gs)

    want = jax.grad(jfn, argnums=tuple(range(6)))(*map(jnp.asarray, ins))
    leaves = [torch.tensor(x, requires_grad=True) for x in ins]
    xh_t, dt_t, a_t, bm_t, cm_t, s0_t = leaves
    la = torch.log(torch.clamp(a_t, min=1e-20))
    y, st = ssd_scan_plain(xh_t * dt_t[..., None], la, bm_t, cm_t, s0_t)
    got = torch.autograd.grad(
        (y * torch.from_numpy(gy)).sum() + (st * torch.from_numpy(gs)).sum(),
        leaves)
    _grads_close(("x", "dt", "a", "B", "C", "state0"), got, want)


def test_gated_norm_plain_gradients_match_reference():
    """gated_rmsnorm_plain under autograd against jax.grad of the
    reference's gated output norm (``rmsnorm(y.astype(z.dtype) *
    silu(z))``) at zamba2 SMOKE's rows and d_inner, float32."""
    rng = np.random.default_rng(3)
    f = np.float32
    y, z, g = (rng.normal(size=(64, 128)).astype(f) for _ in range(3))
    scale = (1 + 0.1 * rng.normal(size=128)).astype(f)

    def jfn(y, z, scale):
        out = JL.rmsnorm({"scale": scale}, y.astype(z.dtype) * jax.nn.silu(z))
        return jnp.sum(out * g)

    want = jax.grad(jfn, argnums=(0, 1, 2))(*map(jnp.asarray, (y, z, scale)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (y, z, scale)]
    out = gated_rmsnorm_plain(*leaves)
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)
    _grads_close(("y", "z", "scale"), got, want)


def test_scans_under_autograd_take_no_out_state():
    """An in-place final state is refused where autograd tracks the scan
    (training passes none); without a gradient it is serving's call."""
    from repro_torch.kernels import ops
    f = torch.float32
    r, k, w = (torch.rand(1, 4, 2, 8, dtype=f) for _ in range(3))
    v, u = torch.rand(1, 4, 2, 8), torch.rand(2, 8)
    s0, h0 = torch.zeros(1, 2, 8, 8), torch.zeros(1, 2, 4, 8)
    xdt, la = torch.rand(1, 4, 2, 8), -torch.rand(1, 4, 2)
    bm, cm = torch.rand(1, 4, 4), torch.rand(1, 4, 4)
    with pytest.raises(ValueError, match="out_state"):
        ops.rwkv6_scan(r.requires_grad_(True), k, v, w, u, s0, out_state=s0)
    with pytest.raises(ValueError, match="out_state"):
        ops.ssd_scan(xdt.requires_grad_(True), la, bm, cm, h0, out_state=h0)
    y, st = ops.rwkv6_scan(r.detach(), k, v, w, u, s0, out_state=s0)
    assert st is s0 and y.shape == (1, 4, 2, 8)
