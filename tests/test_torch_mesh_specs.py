"""The port's serving-mesh rules against the reference's, host-only: the
params', page storage's, quantized params' and decode state's mesh specs
axis name for axis name for every ported arch, ``validate_serve_mesh``'s
messages, the launcher's ``parse_mesh``, the engine's mesh refusals, and
the pieces under them (``make_mesh`` in a world of one, ``Comm.axis``,
``shard_leaf``, the pool's local leaves)."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jax_smoke_config
from repro.launch import serve as jax_launch
from repro.models.api import build_model as jax_build_model
from repro.serve import quant as JQ
from repro_torch.configs import list_archs, smoke_config
from repro_torch.core import comm as C
from repro_torch.launch import serve as launch
from repro_torch.models.api import build_model
from repro_torch.models.module import shard_leaf, shard_params
from repro_torch.serve import pages as PG
from repro_torch.serve import quant as QZ
from repro_torch.serve.disagg import DisaggServeEngine
from repro_torch.serve.engine import ServeEngine

ARCHS = list_archs()


def _pair(arch, **kw):
    return (jax_build_model(jax_smoke_config(arch).replace(**kw)),
            build_model(smoke_config(arch).replace(**kw)))


def _same_tree(want, got, path=()):
    if isinstance(got, dict):
        assert set(want) == set(got), (path, set(want) ^ set(got))
        for k in got:
            _same_tree(want[k], got[k], path + (k,))
    else:
        assert tuple(want) == tuple(got), (path, want, got)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_storage_specs_match_reference(arch):
    """``serve_param_specs`` at ep 1 and 2, ``paged_storage_specs`` with
    float and int8 pages, and ``quantize_param_specs`` over the int8 tree
    (the reference's mirrors its float tree; the port takes either):
    equal, axis name for axis name.  A family without a paged KV cache
    refuses the TP specs, as the reference's does."""
    jm, m = _pair(arch)
    if not m.supports_paged_decode() or arch == "whisper-tiny":
        # whisper pages its K/V but serves on no mesh: it refuses the TP
        # specs too, and its pages' specs are still the rule's
        for model in (jm, m):
            with pytest.raises(NotImplementedError, match="slot-parallel"):
                model.serve_param_specs()
        if m.supports_paged_decode():
            for q in (None, "int8"):
                _same_tree(jm.paged_storage_specs(JQ.make_kv_quant(q)),
                           m.paged_storage_specs(QZ.make_kv_quant(q)))
        return
    for ep in (1, 2):
        _same_tree(jm.serve_param_specs(ep=ep), m.serve_param_specs(ep=ep))
    for q in (None, "int8"):
        _same_tree(jm.paged_storage_specs(JQ.make_kv_quant(q)),
                   m.paged_storage_specs(QZ.make_kv_quant(q)))
    want = JQ.quantize_param_specs(jm.serve_param_specs(),
                                   jm.init(jax.random.PRNGKey(0)))
    params = m.init(0, device="cpu")
    for tree in (params, QZ.quantize_params(params)):
        _same_tree(want, QZ.quantize_param_specs(m.serve_param_specs(),
                                                 tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_match_reference(arch):
    """``serve_state_specs``: the slot axis of every decode-state leaf over
    ``"model"``."""
    jm, m = _pair(arch)
    _same_tree(jm.serve_state_specs(4, 32), m.serve_state_specs(4, 32))


MESHES = [(tp, ep) for tp in (1, 2, 3, 4, 8) for ep in (1, 2, 3)]


@pytest.mark.parametrize("arch", ARCHS)
def test_validate_serve_mesh_messages(arch):
    """Every (tp, ep) of MESHES: the port raises where the reference does,
    with the reference's message (every indivisible dimension named)."""
    jm, m = _pair(arch)
    for tp, ep in MESHES:
        try:
            jm.validate_serve_mesh(tp=tp, ep=ep)
            want = None
        except ValueError as e:
            want = str(e)
        try:
            m.validate_serve_mesh(tp=tp, ep=ep)
            got = None
        except ValueError as e:
            got = str(e)
        assert got == want, (tp, ep)
        if ep == 1 and m.supports_paged_decode():
            try:
                m.validate_serve_tp(tp)
                assert want is None
            except ValueError as e:
                assert str(e) == want


@pytest.mark.parametrize("spec", ["tp=0", "tp=2,tp=4", "dp=2", "tp=x",
                                  "tp=2,ep=", "ep=-1"])
def test_parse_mesh_errors_match_reference(spec):
    with pytest.raises(SystemExit) as want:
        jax_launch.parse_mesh(spec)
    with pytest.raises(SystemExit) as got:
        launch.parse_mesh(spec)
    assert str(got.value) == str(want.value)


def test_parse_mesh_shapes():
    """The reference's layouts: ``tp=N`` a 1-D ("model",) mesh, any ``ep``
    the 2-D ("expert", "model") one (``ep=M`` alone: tp 1)."""
    assert launch.parse_mesh(None) is None
    assert launch.parse_mesh("tp=4") == ((4,), ("model",))
    assert launch.parse_mesh("tp=2,ep=4") == ((4, 2), ("expert", "model"))
    assert launch.parse_mesh("ep=2") == ((2, 1), ("expert", "model"))
    with pytest.raises(SystemExit, match="tp=N"):
        launch.parse_args(["--mesh", "tp=two"])


class _Mesh:
    """The layout half of :class:`repro_torch.core.comm.Mesh` without a
    process group: the engine's refusals and ``shard_leaf`` read only
    these."""
    index = C.Mesh.index

    def __init__(self, shape, names, coords=None):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))
        self.coords = dict(zip(names, coords or (0,) * len(shape)))

    def comm(self, name):
        return C.SerialComm()


def test_engine_mesh_refusals():
    """The reference's messages: a mesh without a ``"model"`` axis; the
    slot-parallel path with an expert axis or with ``max_slots`` not a
    multiple of tp; a paged family whose heads do not divide; and the
    disaggregated pair's thread executor under a mesh."""
    m = build_model(smoke_config("qwen2-7b"))
    params = m.init(0, device="cpu")
    kw = dict(max_slots=4, max_len=32, device="cpu")
    with pytest.raises(ValueError, match=r"serving mesh needs a 'model' "
                       r"axis, got \('data',\)"):
        ServeEngine(m, params, mesh=_Mesh((2,), ("data",)), **kw)
    with pytest.raises(ValueError, match="needs the paged MoE path"):
        ServeEngine(m, params, paged=False,
                    mesh=_Mesh((2, 1), ("expert", "model")), **kw)
    with pytest.raises(ValueError, match=r"max_slots=4 must divide by tp=3"):
        ServeEngine(m, params, paged=False, mesh=_Mesh((3,), ("model",)),
                    **kw)
    with pytest.raises(ValueError, match=r"padded_q_heads=4 \(tp=3\)"):
        ServeEngine(m, params, mesh=_Mesh((3,), ("model",)), **kw)
    with pytest.raises(ValueError, match="dense family with no experts"):
        ServeEngine(m, params, mesh=_Mesh((2, 1), ("expert", "model")), **kw)
    with pytest.raises(ValueError, match="executor='thread' with a mesh"):
        DisaggServeEngine(m, params, executor="thread",
                          mesh=_Mesh((1,), ("model",)), **kw)


def _world_one(comm):
    mesh = C.make_mesh((1, 1), ("expert", "model"))
    return {"shape": mesh.shape, "coords": mesh.coords,
            "axes": [mesh.comm(a).axis for a in mesh.axis_names],
            "sizes": [mesh.comm(a).size() for a in mesh.axis_names],
            "world": (mesh.world.axis, mesh.world.size()),
            "gather": mesh.comm("model").all_gather(torch.arange(3.0),
                                                    tiled=True)}


def test_make_mesh_in_a_world_of_one(tmp_path):
    """``make_mesh`` inside a (gloo) world of one: the reference's shape
    dict, one Comm an axis that names it; the serial transport names none
    (the one test that tells a mesh from serial); outside a world it
    refuses."""
    got = C.run_ranks(_world_one, world=1, store_dir=tmp_path,
                      device="cpu")[0]
    assert got["shape"] == {"expert": 1, "model": 1}
    assert got["coords"] == {"expert": 0, "model": 0}
    assert got["axes"] == ["expert", "model"] and got["sizes"] == [1, 1]
    assert got["world"] == (("expert", "model"), 1)
    assert torch.equal(got["gather"], torch.arange(3.0))
    assert C.SerialComm().axis is None and C.Comm().axis == "world"
    with pytest.raises(RuntimeError, match="initialized world"):
        C.make_mesh((1,), ("model",))


def _size(comm):
    return comm.size()


def test_run_ranks_takes_a_relative_store_dir(tmp_path, monkeypatch):
    """The launchers' default store (``build/ranks``) is relative: the
    group must still meet (a ``file://`` URL of a relative path names a
    host, and the rendezvous would wait forever)."""
    monkeypatch.chdir(tmp_path)
    assert C.run_ranks(_size, world=1, store_dir="build/ranks",
                       device="cpu", timeout=60) == [1]
    assert (tmp_path / "build" / "ranks").is_dir()


def test_collectives_probe_on_one_gloo_rank(tmp_path):
    """``python -m repro_torch.launch.collectives`` on one gloo rank: every
    collective of a tensor-parallel decode step is timed (host-issued ms a
    call) and printed as one JSON object."""
    from repro_torch.launch import collectives
    out = collectives.main(["--device", "cpu", "--calls", "2",
                            "--store-dir", str(tmp_path)])
    assert sorted(out) == sorted([
        "clone (4, d)", "Comm.all_reduce_sum (4, d)",
        "Comm.all_gather tiled (4, d)", "Comm.all_to_all (128, 4, 4096)",
        "dist.all_reduce (4, d)"])
    assert all(ms > 0 for ms in out.values())


@pytest.mark.parametrize("coords", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_shard_leaf_cuts_the_reference_layout(coords):
    """On an (expert 2, model 2) mesh a rank's cut of an expert stack split
    over ("expert", "model") is block e * 2 + m of four, of a vocab-split
    unembedding its model column block; an unsplit leaf is returned
    itself, a split one is a copy of its own."""
    mesh = _Mesh((2, 2), ("expert", "model"), coords)
    e, m = coords
    x = torch.arange(8 * 3 * 6, dtype=torch.float32).reshape(8, 3, 6)
    got = shard_leaf(x, (("expert", "model"), None, "model"), mesh)
    want = np.split(np.split(x.numpy(), 4)[e * 2 + m], 2, axis=2)[m]
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.untyped_storage().nbytes() == got.numel() * 4
    assert shard_leaf(x, (None, None, None), mesh) is x
    one = _Mesh((1,), ("model",))
    assert shard_leaf(x, ("model", None, None), one) is x
    q = {"w": {"q8": x.to(torch.int8), "s8": torch.tensor(0.5)}}
    out = shard_params(q, {"w": {"q8": (None, None, "model"), "s8": ()}},
                       mesh)
    assert out["w"]["s8"] is q["w"]["s8"]
    assert out["w"]["q8"].shape == (8, 3, 3)
    with pytest.raises(ValueError, match="does not split"):
        shard_leaf(x, (None, ("expert", "model"), None), mesh)


def test_local_leaf_specs():
    """A rank's pool leaves hold Hkv / tp heads (the scale leaves too)."""
    m = build_model(smoke_config("qwen2-7b").replace(n_heads=8,
                                                     n_kv_heads=4))
    specs = m.paged_leaf_specs(QZ.make_kv_quant("int8"))
    local = PG.local_leaf_specs(specs, 2)
    for name, s in specs.items():
        assert local[name].suffix == (s.suffix[0] // 2,) + s.suffix[1:]
        assert (local[name].prefix, local[name].dtype) == (s.prefix, s.dtype)
    with pytest.raises(ValueError, match="tp=3"):
        PG.local_leaf_specs(specs, 3)
