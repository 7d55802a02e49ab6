"""The paper's three applications on the port (``repro_torch.apps``)
against the JAX package's (``repro.apps``) on the same keys and inputs,
and the reference's science checks (``tests/test_apps.py``) on the port.

Randomness follows the reference's key path, so the uniform bits are the
reference's bit for bit; the normals differ from XLA's by ulps of
``erfinv`` (up to 1.6e-5 in the tails), which is what the tolerances
below absorb."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import boussinesq as jbq
from repro.apps import dmc as jdmc
from repro.apps import mcmc as jmcmc
from repro_torch.apps import boussinesq as bq
from repro_torch.apps import dmc, mcmc
from repro_torch.core.comm import Comm
from repro_torch.core.runtime import MeshExecutor, VmapExecutor
from repro_torch.serve import prng

CPU = "cpu"


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# §4.1 MCMC ideal points
# ---------------------------------------------------------------------------

def _votes(seed, n_leg, n_votes):
    """The reference's roll calls, and the port's from the same key."""
    y, truth = jmcmc.make_synthetic_votes(jax.random.PRNGKey(seed), n_leg,
                                          n_votes)
    ty, ttruth = mcmc.make_synthetic_votes(prng.PRNGKey(seed), n_leg,
                                           n_votes, device=CPU)
    return y, truth, ty, ttruth


def test_mcmc_uniform_bits_and_votes_match_reference():
    """The truncated normal's uniforms bit for bit (the same key split the
    same way); the synthetic votes equal, their ideal points within the
    normals' erfinv ulps (1e-5)."""
    key = jax.random.PRNGKey(4)
    for k in jax.random.split(key, 3):
        want = jax.random.uniform(k, (7, 9), minval=1e-6, maxval=1 - 1e-6)
        got = prng.uniform(_t(k).to(torch.int64), (7, 9), minval=1e-6,
                           maxval=1 - 1e-6)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    y, truth, ty, ttruth = _votes(2, 20, 40)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(y))
    for k in ("x", "beta", "alpha"):
        np.testing.assert_allclose(ttruth[k].numpy(), np.asarray(truth[k]),
                                   rtol=0, atol=1e-5)


def test_mcmc_gibbs_step_from_reference_state():
    """One Gibbs sweep from the reference's initial state and key: within
    1e-5 of the reference's first draw."""
    y, _, _, _ = _votes(2, 20, 40)
    key = jax.random.PRNGKey(3)
    k0, kscan = jax.random.split(key)
    x0 = jax.random.normal(k0, (20,)) * 0.1
    want = jmcmc.run_chain(key, y, n_iter=1, burn=0, thin=1)["x_draws"][0]
    step_key = _t(jax.random.split(kscan, 1)[0]).to(torch.int64)
    x, beta, alpha = mcmc.gibbs_step(
        (_t(x0), torch.zeros(40), torch.zeros(40)), step_key,
        _t(y) > 0.5)
    np.testing.assert_allclose(x.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    got = mcmc.run_chain(prng.PRNGKey(3, device=CPU), _t(y), n_iter=1,
                         burn=0, thin=1)["x_draws"][0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("solver", ["serial", "vmap"])
def test_mcmc_chains_match_reference(solver):
    """The reference test's chains (2 chains of 40 iterations, burn 20,
    seed 3, on 20 x 40 votes): posterior means within 1e-3."""
    y, _, ty, _ = _votes(2, 20, 40)
    want = getattr(jmcmc, f"solve_{solver}")(
        jmcmc.IdealPointProblem(y, n_chains=2, n_iter=40, burn=20, seed=3))
    got = getattr(mcmc, f"solve_{solver}")(
        mcmc.IdealPointProblem(ty, n_chains=2, n_iter=40, burn=20, seed=3))
    np.testing.assert_allclose(got["x_mean"].numpy(),
                               np.asarray(want["x_mean"]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["rhat"].numpy(), np.asarray(want["rhat"]),
                               rtol=0, atol=1e-3)


def test_mcmc_executor_selection_matches():
    """Every executor runs the same chains (the reference's check, plus
    the mesh executor alone at world 1)."""
    _, _, ty, _ = _votes(2, 12, 24)

    def problem():
        return mcmc.IdealPointProblem(ty, n_chains=2, n_iter=30, burn=10,
                                      seed=3)

    ref = mcmc.solve(problem(), "serial")
    for spec in ("vmap", "thread", "mesh"):
        got = mcmc.solve(problem(), spec)
        np.testing.assert_allclose(got["x_mean"].numpy(),
                                   ref["x_mean"].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=spec)


def test_mcmc_recovers_ideal_points():
    _, _, ty, ttruth = _votes(1, 50, 120)
    res = mcmc.solve_vmap(mcmc.IdealPointProblem(ty, n_chains=4, n_iter=120,
                                                 burn=60))
    corr = abs(np.corrcoef(res["x_mean"].numpy(), ttruth["x"].numpy())[0, 1])
    assert corr > 0.85, corr


def test_trunc_normal_signs():
    key = prng.PRNGKey(0, device=CPU)
    mu = torch.zeros(1000)
    assert (mcmc._trunc_normal(key, mu, torch.ones(1000, dtype=bool))
            > 0).all()
    assert (mcmc._trunc_normal(key, mu, torch.zeros(1000, dtype=bool))
            < 0).all()


# ---------------------------------------------------------------------------
# §4.2 Diffusion Monte Carlo
# ---------------------------------------------------------------------------

def test_walker_step_matches_reference():
    """The same key and state: the count equal, the positions within 1e-5
    (the diffusion's normals), the dead slots zero."""
    key = jax.random.PRNGKey(0)
    pos = jax.random.normal(key, (64, 3))
    for count, e_trial in ((40, 1.5), (64, 3.0), (0, 1.5)):
        jp, jc, jo = jdmc.walker_step(key, pos, jnp.asarray(count, jnp.int32),
                                      jnp.asarray(e_trial), tau=0.01)
        tp, tc, to = dmc.walker_step(
            prng.PRNGKey(0), _t(pos), torch.tensor(count, dtype=torch.int32),
            torch.tensor(e_trial), tau=0.01)
        assert int(tc) == int(jc) and tc.dtype == torch.int32
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(float(to["pot"]), float(jo["pot"]),
                                   rtol=1e-5, atol=1e-6)


def test_dmc_run_serial_matches_reference():
    """300 walkers, 50 steps: the population equal at every step, E_T
    within 1e-5."""
    want = jdmc.run_serial(n_walkers=300, timesteps=50, tau=0.02, seed=0)
    got = dmc.run_serial(n_walkers=300, timesteps=50, tau=0.02, seed=0,
                         device=CPU)
    np.testing.assert_array_equal(got["counts"].numpy(),
                                  np.asarray(want["counts"]))
    np.testing.assert_allclose(got["e_trial"].numpy(),
                               np.asarray(want["e_trial"]), rtol=0, atol=1e-5)


def test_dmc_run_parallel_world1_matches_reference(tmp_path):
    """The SPMD driver at world 1 (an in-process gloo group) against the
    reference's on its one-device mesh: the counts equal at every step, E_T
    within 1e-5, and no rebalance."""
    mesh = jax.make_mesh((1,), ("data",))
    want = jdmc.run_parallel(mesh, n_walkers=256, timesteps=60, tau=0.02,
                             seed=2)
    got = dmc.run_parallel(256, 60, world=1, store_dir=tmp_path, tau=0.02,
                           seed=2, device=CPU)
    assert not torch.distributed.is_initialized()
    np.testing.assert_array_equal(got["counts"].numpy(),
                                  np.asarray(want["counts"]))
    np.testing.assert_array_equal(got["local_counts"].numpy(),
                                  np.asarray(want["local_counts"]))
    np.testing.assert_allclose(got["e_trial"].numpy(),
                               np.asarray(want["e_trial"]), rtol=0, atol=1e-5)
    assert got["rebalances"] == int(want["rebalances"]) == 0


def test_dmc_ground_state_energy():
    out = dmc.run_serial(n_walkers=300, timesteps=500, tau=0.02, seed=0,
                         device=CPU)
    assert abs(float(out["e0_estimate"]) - 1.5) < 0.15


def test_dmc_population_control():
    out = dmc.run_serial(n_walkers=200, timesteps=300, tau=0.02, seed=1,
                         device=CPU)
    counts = out["counts"].numpy()
    assert counts.min() > 50 and counts.max() < 800
    assert abs(counts[-50:].mean() - 200) < 80


def test_walker_step_compaction_invariants():
    rng = np.random.default_rng(0)
    pos = torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32))
    new_pos, new_count, _ = dmc.walker_step(
        prng.PRNGKey(0), pos, torch.tensor(40, dtype=torch.int32),
        torch.tensor(1.5), tau=0.01)
    n = int(new_count)
    assert 0 <= n <= 64
    assert not new_pos[n:].any()
    assert torch.isfinite(new_pos[:n]).all()


def test_dmc_replica_farm():
    """The thread farm agrees with the serial executor on the same seeds
    (the reference's check)."""
    out = dmc.run_replicas(n_replicas=2, executor="thread", num_workers=2,
                           n_walkers=80, timesteps=120, tau=0.02, seed=0,
                           device=CPU)
    assert abs(float(out["e0_estimate"]) - 1.5) < 0.4
    assert len(out["replicas"]) == 2
    ref = dmc.run_replicas(n_replicas=2, executor="serial", n_walkers=80,
                           timesteps=120, tau=0.02, seed=0, device=CPU)
    np.testing.assert_allclose(float(out["e0_estimate"]),
                               float(ref["e0_estimate"]), rtol=1e-5)


def test_entry_points_default_to_the_card():
    """Without ``device="cpu"`` the apps run on ``cuda``, and raise where
    no card is visible instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dmc.run_serial(n_walkers=8, timesteps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bq.run_serial(bq.BoussinesqParams(nx=8, ny=8), 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mcmc.make_synthetic_votes(prng.PRNGKey(0), 4, 4)


# ---------------------------------------------------------------------------
# §4.3 Boussinesq
# ---------------------------------------------------------------------------

BQ = dict(nx=48, ny=48, dt=0.02, eps=0.3, alpha=0.05)


def test_boussinesq_run_serial_matches_reference():
    """48 x 48, 30 steps: eta and phi within 1e-5, the Jacobi iterations
    equal at every step."""
    eta, phi, hist = jbq.run_serial(jbq.BoussinesqParams(**BQ), steps=30)
    teta, tphi, thist = bq.run_serial(bq.BoussinesqParams(**BQ), 30,
                                      device=CPU)
    np.testing.assert_allclose(teta.numpy(), np.asarray(eta), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tphi.numpy(), np.asarray(phi), rtol=0,
                               atol=1e-5)
    assert thist["iters"] == np.asarray(hist["iters"]).tolist()
    np.testing.assert_allclose(thist["probe"].numpy(),
                               np.asarray(hist["probe"]), rtol=0, atol=1e-5)


def test_boussinesq_run_parallel_world1_matches_reference(tmp_path):
    """The Schwarz route at world 1 (an in-process gloo group) against the
    reference's on its one-device mesh: eta and phi within 1e-5, the
    Schwarz iterations equal at every step."""
    mesh = jax.make_mesh((1,), ("data",))
    eta, phi, hist = jbq.run_parallel(mesh, jbq.BoussinesqParams(**BQ),
                                      steps=20)
    teta, tphi, thist = bq.run_parallel(bq.BoussinesqParams(**BQ), 20,
                                        world=1, store_dir=tmp_path,
                                        device=CPU)
    np.testing.assert_allclose(teta.numpy(), np.asarray(eta), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(tphi.numpy(), np.asarray(phi), rtol=0,
                               atol=1e-5)
    assert thist["iters"] == np.asarray(hist["iters"]).tolist()


def test_boussinesq_executor_dispatch():
    """``run`` on a serial and a mesh executor (world 1, no group): the
    mass within 1e-4 (the reference's check); any other executor is
    refused by name."""
    p = bq.BoussinesqParams(nx=24, ny=24, dt=0.02)
    _, _, hist = bq.run(p, 5, executor="serial", device=CPU)
    _, _, hist_m = bq.run(p, 5, executor=MeshExecutor(Comm()), device=CPU)
    np.testing.assert_allclose(hist_m["mass"].numpy(), hist["mass"].numpy(),
                               atol=1e-4)
    with pytest.raises(TypeError, match="serial.*or.*mesh"):
        bq.run(p, 2, executor=VmapExecutor(), device=CPU)


def test_boussinesq_mass_conserved():
    p = bq.BoussinesqParams(nx=48, ny=48, dt=0.02)
    _, _, hist = bq.run_serial(p, 30, device=CPU)
    mass = hist["mass"].numpy()
    assert abs(mass[-1] - mass[0]) < 1e-3 * abs(mass[0]) + 1e-3


def test_boussinesq_wave_oscillates():
    """The standing-wave probe at x = Lx/4 oscillates, neither decaying
    nor blowing up."""
    p = bq.BoussinesqParams(nx=48, ny=48, dt=0.05, eps=0.2)
    _, _, hist = bq.run_serial(p, 200, k_mode=1, device=CPU)
    probe = hist["probe"].numpy()
    assert np.isfinite(probe).all()
    assert probe.max() > 0.01 and probe.min() < -0.01
    assert abs(probe).max() < 0.2


def test_boussinesq_dispersion_slows_waves():
    """Larger eps (dispersion): slower oscillation (probe zero
    crossings)."""
    def crossings(eps):
        p = bq.BoussinesqParams(nx=48, ny=48, dt=0.05, eps=eps)
        _, _, hist = bq.run_serial(p, 400, k_mode=4, device=CPU)
        return int((np.diff(np.sign(hist["probe"].numpy())) != 0).sum())

    assert crossings(1.0) < 0.8 * crossings(0.01)


def test_jacobi_solves_helmholtz():
    """The 'legacy serial kernel' solves (I - c∇²)x = b (BC refreshed
    between sweep batches, as the Schwarz loop does)."""
    p = bq.BoussinesqParams(nx=32, ny=32)
    rng = np.random.default_rng(0)
    rhs = torch.from_numpy((rng.normal(size=(32, 32)) * 0.1).astype(
        np.float32))
    x = torch.zeros((34, 32))
    for _ in range(150):
        x = bq.apply_physical_bc(x, None)
        x = bq.jacobi_sweeps(x, rhs, p.c, p.dx, 6)
    x = bq.apply_physical_bc(x, None)
    resid = rhs - (x[1:-1] - p.c * bq.laplacian(x, p.dx))
    assert float(resid.abs().max()) < 1e-4


def test_stencils_match_reference():
    """The stencils on one numpy-seeded ghost-padded block, within float32
    rounding (1e-5 of values up to ~300)."""
    rng = np.random.default_rng(3)
    f = rng.normal(size=(10, 7)).astype(np.float32)
    k = rng.normal(size=(10, 7)).astype(np.float32)
    for name in ("laplacian", "grad_sq"):
        np.testing.assert_allclose(
            getattr(bq, name)(_t(f), 0.1).numpy(),
            np.asarray(getattr(jbq, name)(jnp.asarray(f), 0.1)),
            rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        bq.div_k_grad(_t(k), _t(f), 0.1).numpy(),
        np.asarray(jbq.div_k_grad(jnp.asarray(k), jnp.asarray(f), 0.1)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        bq.jacobi_sweeps(_t(f), _t(k[1:-1]), 0.1, 0.1, 6).numpy(),
        np.asarray(jbq.jacobi_sweeps(jnp.asarray(f), jnp.asarray(k[1:-1]),
                                     0.1, 0.1, 6)), rtol=1e-5, atol=1e-6)
