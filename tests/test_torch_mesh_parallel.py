"""The port's ``repro_torch.mesh`` against the reference's ``repro.mesh`` on
the CPU: ring attention over gloo at worlds 2 and 4 against the
reference's full causal attention on one device, the GPipe forward at
world 4 against the reference's sequential ``reference_apply``, and the
logical-axis rules leaf for leaf over every SMOKE arch's param specs (no
process spawned).  Each world is spawned once for the file
(:func:`_torch_ranks.mesh_parallel`)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_ranks as R
from repro.configs import list_archs as jax_list_archs
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels import ref as jref
from repro.mesh import axes as JA
from repro.mesh import pipeline as JP
from repro.models.api import build_model as jax_build_model
from repro.train.step import _strip_axis as jax_strip_axis
from repro_torch.configs import smoke_config
from repro_torch.core import comm as C
from repro_torch.mesh import axes as PA
from repro_torch.mesh import bubble_fraction
from repro_torch.mesh.pipeline import reference_apply
from repro_torch.models.api import build_model
from repro_torch.train import checkpoint as ckpt

RING_TOL = 2e-4          # the reference test's
PIPE_TOL = 1e-5


class _FakeMesh:
    def __init__(self, names):
        self.axis_names = names


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    cache = {}

    def get(n):
        if n not in cache:
            cache[n] = C.run_ranks(R.mesh_parallel, (), world=n,
                                   store_dir=tmp_path_factory.mktemp(
                                       f"par{n}"), device="cpu", timeout=300)
        return cache[n]
    return get


@pytest.mark.parametrize("n", [2, 4])
def test_ring_attention_matches_full_attention(worlds, n):
    q, k, v = R.ring_inputs()
    want = np.asarray(jref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), causal=True))
    got = torch.cat([r["ring"] for r in worlds(n)], dim=1).numpy()
    np.testing.assert_allclose(got, want, rtol=RING_TOL, atol=RING_TOL)


def test_pipeline_matches_sequential(worlds):
    """Every rank's pipeline output, and the port's own sequential oracle,
    against the reference's ``reference_apply``."""
    params, x = R.pipe_inputs()

    def stage_fn(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])
    want = np.asarray(JP.reference_apply(
        stage_fn, jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    for r in worlds(R.PIPE["n_stages"]):
        np.testing.assert_allclose(r["pipe"].numpy(), want, rtol=PIPE_TOL,
                                   atol=PIPE_TOL)
    seq = reference_apply(R.pipe_stage,
                          {k: torch.from_numpy(a) for k, a in params.items()},
                          torch.from_numpy(x))
    np.testing.assert_allclose(seq.numpy(), want, rtol=PIPE_TOL,
                               atol=PIPE_TOL)


def test_bubble_fraction():
    assert abs(bubble_fraction(4, 6) - 3 / 9) < 1e-5
    assert bubble_fraction(4, 6) == JP.bubble_fraction(4, 6)
    assert bubble_fraction(1, 8) == 0.0


def _jax_spec_leaves(defs):
    return [p.spec for p in jax.tree.leaves(
        defs, is_leaf=lambda x: hasattr(x, "spec") and hasattr(x, "shape"))]


@pytest.mark.parametrize("arch", jax_list_archs())
def test_rules_match_reference_leaf_for_leaf(arch):
    """The port's logical specs through rules_for_mesh equal the
    reference's, leaf for leaf (in the reference's sorted-key order), on a
    one-pod and a two-pod mesh, with and without an override, and through
    serial_rules and the pod-stripped rules."""
    jdefs = jax_build_model(jax_smoke_config(arch)).param_defs()
    pdefs = build_model(smoke_config(arch)).param_defs()
    jspecs = _jax_spec_leaves(jdefs)
    pspecs = [p.logical_axes() for _, p in ckpt._leaves(pdefs)]
    assert len(jspecs) == len(pspecs)
    for names in (("data", "model"), ("pod", "data", "model")):
        for over in (None, {"expert_mlp": "data"}):
            jr = JA.rules_for_mesh(_FakeMesh(names), over)
            pr = PA.rules_for_mesh(_FakeMesh(names), over)
            assert dict(jr.rules) == dict(pr.rules)
            rule_sets = [(jr, pr), (JA.serial_rules(), PA.serial_rules())]
            if "pod" in names:
                rule_sets.append((jax_strip_axis(jr, "pod"),
                                  PA.strip_axis(pr, "pod")))
            for j, p in rule_sets:
                for js, ps in zip(jspecs, pspecs):
                    assert tuple(JA.logical_to_mesh(js, j)) == \
                        PA.logical_to_mesh(ps, p), (arch, js, ps)
                    want = tuple(JA.logical_to_mesh(P(*ps), j))
                    assert PA.logical_to_mesh(ps, p) == want


def test_rules_tables_and_unknown_axis():
    assert dict(PA.LOGICAL_RULES_1POD.rules) == dict(JA.LOGICAL_RULES_1POD.rules)
    assert dict(PA.LOGICAL_RULES_2POD.rules) == dict(JA.LOGICAL_RULES_2POD.rules)
    with pytest.raises(KeyError):
        PA.LOGICAL_RULES_1POD.get("nope")
    sh = PA.logical_to_sharding(("batch", "seq"), "m", PA.LOGICAL_RULES_2POD)
    assert sh == PA.Sharding("m", (("pod", "data"), "model"))
