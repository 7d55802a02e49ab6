"""SPMD bodies that the port's multi-rank tests run on every rank of a gloo
group (``repro_torch.core.comm.run_ranks``).  Spawned ranks import this
module afresh, so it imports torch and the port only, never JAX.

Each rank's inputs come from ``numpy.random.default_rng((SEED, rank))``
(:func:`rank_input`), so the parent test can rebuild every rank's inputs
and hold the collected results against a numpy model."""
import contextlib
import time

import numpy as np
import torch

from repro_torch.apps import boussinesq as bq
from repro_torch.apps import dmc
from repro_torch.core.collect import collect_subproblem_output_args
from repro_torch.core.load_balance import (dynamic_load_balancing,
                                           redistribute_work)
from repro_torch.core.runtime import MeshExecutor
from repro_torch.core.schwarz import halo_exchange

SEED = 20
CAP = 16
BQ = dict(nx=48, ny=48, dt=0.02, eps=0.3, alpha=0.05)
BQ_STEPS = 40                   # tests/test_distributed.py's gate
PARABOLA_M = 15                 # 225 tasks: padded at worlds 2 and 4


def rank_input(rank: int, n: int) -> dict:
    """Rank ``rank``'s inputs in a world of ``n``."""
    rng = np.random.default_rng((SEED, rank))
    return {"x": rng.normal(size=(3, 2 * n, 4)).astype(np.float32),
            "sq": rng.normal(size=(n, 2, 3)).astype(np.float32),
            "field": rng.normal(size=(6, 5)).astype(np.float32),
            "count": int(rng.integers(0, CAP + 1)),
            "skew": (9, 5) + (0,) * (n - 2)}


def parabola_inputs(m: int = PARABOLA_M):
    """The quickstart parabola's float32 inputs (16 points on [0, 10]; the
    (a, b) grid), from numpy, so the JAX package can take the same."""
    vals = np.linspace(-1, 1, m, dtype=np.float32)
    aa, bb = np.meshgrid(vals, vals, indexing="ij")
    return np.linspace(0, 10.0, 16, dtype=np.float32), aa.ravel(), bb.ravel()


def parabola():
    """The parabola as stacked tasks: (initialize, func)."""
    x, a, b = (torch.from_numpy(v) for v in parabola_inputs())
    return ((lambda: {"a": a, "b": b}),
            (lambda t: t["a"] * x ** 2 + t["b"] * x + 5.0))


def collectives(comm) -> dict:
    """Every Comm collective, halo_exchange, redistribute_work,
    dynamic_load_balancing and collect on this rank's inputs."""
    n, r = comm.size(), comm.rank()
    inp = rank_input(r, n)
    x = torch.from_numpy(inp["x"])
    out = {
        "rank": r, "size": n,
        "gather0": comm.all_gather(x),
        "gather1": comm.all_gather(x, axis=1),
        "gather0_tiled": comm.all_gather(x, tiled=True),
        "gather_last_tiled": comm.all_gather(x, axis=-1, tiled=True),
        "sum": comm.all_reduce_sum(x), "max": comm.all_reduce_max(x),
        "min": comm.all_reduce_min(x),
        "a2a_tiled": comm.all_to_all(x, split_axis=1, concat_axis=0),
        "a2a_tiled_same": comm.all_to_all(x, split_axis=1, concat_axis=1),
        "a2a_untiled": comm.all_to_all(torch.from_numpy(inp["sq"]),
                                       split_axis=0, concat_axis=2,
                                       tiled=False),
        "shift1": comm.shift(x), "shift_back": comm.shift(x, -1),
        "permute_partial": comm.permute(x, [(0, n - 1), (n - 1, 0)]),
        "broadcast": comm.broadcast_from(x, root=n - 1),
        "collect": collect_subproblem_output_args({"x": x[:2]}, comm),
    }
    field = torch.from_numpy(inp["field"])
    for periodic in (False, True):
        out[f"halo_{periodic}"] = halo_exchange(field, comm, 2,
                                                periodic=periodic)
    out["halo_axis1"] = halo_exchange(field, comm, 1, axis=1, periodic=True)
    for case in ("count", "skew"):
        c = inp[case] if case == "count" else inp["skew"][r]
        data = torch.where((torch.arange(CAP) < c)[:, None],
                           100.0 * r + torch.arange(CAP, dtype=torch.float32
                                                    )[:, None], 0.0)
        count = torch.tensor(c, dtype=torch.int32)
        out[f"redistribute_{case}"] = redistribute_work(data, count, comm)
        out[f"dlb_{case}"] = dynamic_load_balancing(data, count, comm)
    return out


def mesh_parabola(comm) -> dict:
    """MeshExecutor over ``comm`` on the parabola: a one-argument finalizer
    (trimmed outputs) and a two-argument one (padded outputs, mask)."""
    init, func = parabola()
    seen = {}

    def fin_mask(out, mask):
        seen["padded"], seen["mask"] = out, mask
        return out[mask]

    return {"trimmed": MeshExecutor(comm).run(init, func, lambda o: o),
            "masked": MeshExecutor(comm).run(init, func, fin_mask), **seen}


def science(comm) -> dict:
    """The Schwarz Boussinesq run and a short load-balanced DMC run."""
    p = bq.BoussinesqParams(**BQ)
    eta, phi, hist = bq.run_rank(comm, p, BQ_STEPS, device="cpu")
    walkers = dmc.run_rank(comm, n_walkers=64 * comm.size(), timesteps=60,
                           tau=0.02, seed=1, device="cpu")
    return {"eta": eta, "phi": phi, "iters": hist["iters"],
            "mass": hist["mass"], "dmc": walkers}


def all_checks(comm) -> dict:
    """What the multi-rank tests read, from one spawn of the world."""
    return {"collectives": collectives(comm), "mesh": mesh_parabola(comm),
            "science": science(comm)}


def moe_inputs(arch: str = "qwen3-moe-235b-a22b", tokens: int = 37):
    """A SMOKE MoE block's float32 inputs from numpy: (x (T, d), the
    block's params {router, gate, up, down} with all E experts).  Column 0
    of x is 1 and the router's row 0 pins experts E-1 and E-2 at logit
    -100, so they never route: an expert placement may evict them.  The
    MoE bodies import the model stack where they run, so the ranks of the
    other bodies start without it."""
    from repro_torch.configs import smoke_config
    cfg = smoke_config(arch)
    E, d, eff = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    rng = np.random.default_rng((SEED, tokens))
    x = rng.normal(size=(tokens, d)).astype(np.float32)
    x[:, 0] = 1.0
    wr = (0.2 * rng.normal(size=(d, E))).astype(np.float32)
    wr[:, E - 2:] = 0.0
    wr[0, E - 2:] = -100.0
    w = {"router": wr}
    for name, shape in (("gate", (E, d, eff)), ("up", (E, d, eff)),
                        ("down", (E, eff, d))):
        w[name] = (0.1 * rng.normal(size=shape)).astype(np.float32)
    return cfg, x, w


def moe_plan(cfg, x, w, ep: int):
    """The placement plan of ``ep`` ranks for the serial block's own
    per-expert counts on these inputs."""
    from repro_torch.core.comm import SerialComm
    from repro_torch.models import moe as M
    from repro_torch.serve import placement as PL
    params = {k: torch.from_numpy(v) for k, v in w.items()}
    _, _, stats = M.moe_apply_expert_parallel(params, torch.from_numpy(x),
                                              cfg, SerialComm())
    return PL.plan_placement(stats["tokens"].numpy(), ep)


def placed_block(w, plan):
    """The block's params permuted into ``plan``'s physical slots (router
    untouched) and its (3, E) dispatch map; the identity layout for None."""
    from repro_torch.serve import placement as PL
    params = {k: torch.from_numpy(v) for k, v in w.items()}
    if plan is None:
        return params, None
    stacked = PL.apply_placement(
        {"blocks": {"moe": {k: v[None] for k, v in params.items()}}}, plan)
    return ({k: v[0] for k, v in stacked["blocks"]["moe"].items()},
            torch.from_numpy(plan.dispatch_arrays()))


def moe_expert_parallel(comm) -> dict:
    """``moe_apply_expert_parallel`` with this rank's E/ep experts, unplaced
    and under the plan of the world's size: y, aux and the telemetry."""
    from repro_torch.models import moe as M
    n, r = comm.size(), comm.rank()
    cfg, x, w = moe_inputs()
    out = {}
    for label, plan in (("unplaced", None),
                        ("placed", moe_plan(cfg, x, w, n))):
        params, placement = placed_block(w, plan)
        e_loc = cfg.n_experts // n
        local = {k: (v if k == "router" else v[r * e_loc:(r + 1) * e_loc])
                 for k, v in params.items()}
        y, aux, stats = M.moe_apply_expert_parallel(
            local, torch.from_numpy(x)[None], cfg, comm, placement=placement)
        out[label] = {"y": y[0], "aux": aux, **stats}
    return out


def failing(comm):
    """A rank that fails while the others wait in a collective."""
    if comm.rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    return comm.all_reduce_sum(torch.ones(1))


def hanging_forever(comm):
    """Rank 0 never reaches the collective the others call: they wait."""
    if comm.rank() == 0:
        time.sleep(600)
    return comm.all_reduce_sum(torch.ones(1))


# ---------------------------------------------------------------------------
# the serving engine on a mesh (tensor, expert and slot parallelism)
# ---------------------------------------------------------------------------

MESH_PROMPTS = [[5, 17, 33, 2, 9], [100, 200, 300], [7] * 11, [1, 2, 3, 4]]
SPEC_PROMPTS = [[5, 17, 33, 5, 17, 33, 5, 17], [7] * 11,
                [1, 2, 3, 4, 1, 2, 3, 4, 1, 2], [9, 9, 8, 8, 9, 9, 8, 8]]
PREEMPT_PROMPTS = [[5, 17, 33, 2, 9, 1, 2, 3], [100, 200, 300, 4, 5, 6, 7, 8]]
SHARED = list(range(1, 25))
PREFIX_WAVES = [[SHARED], [SHARED, SHARED], [SHARED[:20] + [77, 78]]]
BASE_KW = dict(max_slots=4, max_len=64, page_size=8, prefill_chunk=16)
TP = ("model",)
EP = ("expert", "model")
# (arch, engine kwargs, waves, max_new) of every case, by name: each mesh
# run below is held against the reference's single-device engine on these
MESH_CASES = {
    "qwen2": ("qwen2-7b", BASE_KW, [MESH_PROMPTS], 6),
    "qwen2-preempt": ("qwen2-7b", dict(max_slots=2, max_len=64, page_size=16,
                                       num_pages=4, prefill_chunk=16),
                      [PREEMPT_PROMPTS], 30),
    "qwen2-prefix": ("qwen2-7b", dict(max_slots=2, max_len=128, page_size=16,
                                      prefill_chunk=16), PREFIX_WAVES, 12),
    "qwen2-int8": ("qwen2-7b", dict(BASE_KW, kv_quant="int8",
                                    weight_quant="int8"),
                   [MESH_PROMPTS], 6),
    "qwen2-ngram": ("qwen2-7b", dict(max_slots=3, max_len=128, page_size=16,
                                     prefill_chunk=16, spec_decode="ngram"),
                    [SPEC_PROMPTS], 12),
    "qwen2-self1": ("qwen2-7b", dict(max_slots=3, max_len=128, page_size=16,
                                     prefill_chunk=16, spec_decode="self-1"),
                    [SPEC_PROMPTS], 12),
    "qwen2-dense": ("qwen2-7b", dict(BASE_KW, paged=False), [MESH_PROMPTS],
                    6),
    "moe": ("qwen3-moe-235b-a22b", BASE_KW, [MESH_PROMPTS], 6),
    "moe-placed": ("qwen3-moe-235b-a22b", dict(BASE_KW, placement_interval=2),
                   [MESH_PROMPTS], 6),
    "arctic": ("arctic-480b", BASE_KW, [MESH_PROMPTS], 6),
    "rwkv": ("rwkv6-3b", dict(max_slots=4, max_len=64), [MESH_PROMPTS], 6),
}
# the mesh runs of each world: (case, mesh shape, axis names)
MESH_RUNS = {
    2: [("qwen2", (2,), TP), ("qwen2-preempt", (2,), TP),
        ("qwen2-prefix", (2,), TP), ("qwen2-int8", (2,), TP),
        ("qwen2-ngram", (2,), TP), ("qwen2-self1", (2,), TP),
        ("qwen2-dense", (2,), TP), ("moe", (2,), TP), ("moe", (2, 1), EP),
        ("moe-placed", (2, 1), EP), ("arctic", (2,), TP),
        ("rwkv", (2,), TP)],
    4: [("qwen2", (4,), TP), ("moe", (4,), TP), ("moe", (2, 2), EP),
        ("moe-placed", (2, 2), EP)],
}


def mesh_config(arch: str):
    """The port's SMOKE config of a mesh case: 8 query and 4 KV heads, so
    tp 4 splits them (rwkv6 has no attention heads)."""
    from repro_torch.configs import smoke_config
    cfg = smoke_config(arch)
    return cfg if cfg.family == "ssm" else cfg.replace(n_heads=8,
                                                       n_kv_heads=4)


def _serve_case(model, params, mesh, case):
    from repro_torch.serve.engine import ServeEngine
    _, kw, waves, max_new = MESH_CASES[case]
    eng = ServeEngine(model, params, mesh=mesh, device="cpu", **kw)
    for wave in waves:
        for p in wave:
            eng.submit(p, max_new_tokens=max_new)
        eng.run_until_drained()
    eng.close()
    if any(r.error is not None for r in eng.finished):
        raise RuntimeError([r.error for r in eng.finished])
    return {"streams": {r.rid: list(r.output) for r in eng.finished},
            "stats": dict(eng.stats), "tp": eng.tp, "ep": eng.ep}


def percall_inputs(cfg):
    """A prefill chunk (16 tokens at 0, pages 0 and 1 of 8) and a decode
    step of 2 slots after it, from numpy: the per-call check's inputs."""
    rng = np.random.default_rng((SEED, 7))
    return {"chunk": rng.integers(0, cfg.vocab, (1, 16)).astype(np.int32),
            "row": np.arange(8, dtype=np.int32),
            "tables": np.stack([np.arange(8), np.arange(8)]).astype(np.int32),
            "lengths": np.array([16, 9], np.int32),
            "step": rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32),
            "wpages": np.array([2, 1], np.int32),
            "woffs": np.array([0, 1], np.int32)}


def _percall(model, params, mesh) -> dict:
    """tp-way paged prefill chunk then decode on a fresh pool of 8 pages of
    8: the chunk's hidden states and the step's logits."""
    from repro_torch.models.module import shard_params
    from repro_torch.serve import pages as PG
    inp = {k: torch.from_numpy(v) for k, v in
           percall_inputs(model.cfg).items()}
    params = shard_params(params, model.serve_param_specs(), mesh)
    specs = PG.local_leaf_specs(model.paged_leaf_specs(),
                                mesh.shape["model"])
    pool = PG.PagePool(specs, num_pages=8, page_size=8, device="cpu")
    kw = {"comm": mesh.comm("model")}
    hidden, _ = model.paged_prefill_chunk(params, pool.storage, inp["row"],
                                          inp["row"][:2], 0, inp["chunk"],
                                          **kw)
    logits, _ = model.paged_decode_step(
        params, pool.storage, inp["tables"], inp["lengths"], inp["step"],
        inp["wpages"], inp["woffs"], **kw)
    return {"hidden": hidden, "logits": logits}


def _moe_blocks(mesh) -> dict:
    """The MoE block with its experts split over the mesh (serving TP over
    ``"model"``, partitioned over ``"expert"`` where the mesh has it): y,
    aux and the telemetry, unplaced."""
    from repro_torch.core.comm import SerialComm
    from repro_torch.models import moe as M
    from repro_torch.models.module import shard_leaf
    cfg, x, w = moe_inputs()
    axes = tuple(a for a in EP if a in mesh.axis_names)
    params = {k: torch.from_numpy(v) if k == "router" else
              shard_leaf(torch.from_numpy(v), (axes,), mesh)
              for k, v in w.items()}
    ep_comm = mesh.comm("expert") if "expert" in axes else SerialComm()
    y, aux, stats = M.moe_apply_expert_parallel(
        params, torch.from_numpy(x)[None], cfg, ep_comm,
        shard_comm=mesh.comm("model"))
    return {"y": y[0], "aux": aux, **stats}


def _disagg(model, params, mesh) -> dict:
    """The ``"qwen2"`` case through the disaggregated pair (serial), both
    roles on the mesh."""
    from repro_torch.serve.disagg import DisaggServeEngine
    _, kw, waves, max_new = MESH_CASES["qwen2"]
    eng = DisaggServeEngine(model, params, mesh=mesh, device="cpu", **kw)
    for p in waves[0]:
        eng.submit(p, max_new_tokens=max_new)
    eng.run_until_drained()
    eng.close()
    return {"streams": {r.rid: list(r.output) for r in eng.finished},
            "handoffs": eng.stats["prefill"]["kv_handoffs"],
            "injections": eng.stats["decode"]["kv_injections"]}


TRAFFIC = dict(kind="poisson", n_requests=6, rate=4.0, seed=0,
               max_new_tokens=6, shared_prefix_len=8, n_sessions=2)


def _traffic_wall(model, params, mesh) -> dict:
    """An open-loop Poisson run under the wall clock on the ``"qwen2"``
    case's engine: rank 0's clock decides the arrivals."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.traffic import make_workload, run_traffic
    _, kw, _, _ = MESH_CASES["qwen2"]
    eng = ServeEngine(model, params, mesh=mesh, device="cpu", **kw)
    wl = make_workload(vocab=model.cfg.vocab, **TRAFFIC)
    res = run_traffic(eng, wl, clock="wall")
    eng.close()
    return {"outputs": res["outputs"],
            "submits": sum(e["kind"] == "submit" for e in res["events"])}


def _moe_expert_tp(mesh) -> dict:
    """The block in expert TP (``tp_comm``): every expert's ff axis split
    over ``"model"``, the down projection's partial sums all-reduced in
    float32: y, aux and the telemetry."""
    from repro_torch.core.comm import SerialComm
    from repro_torch.models import moe as M
    from repro_torch.models.module import shard_leaf
    cfg, x, w = moe_inputs()
    cut = {"gate": (None, None, "model"), "up": (None, None, "model"),
           "down": (None, "model", None)}
    p = {k: torch.from_numpy(v) if k == "router" else
         shard_leaf(torch.from_numpy(v), cut[k], mesh)
         for k, v in w.items()}
    y, aux, stats = M._dispatch_compute_combine(
        torch.from_numpy(x), p["router"], p["gate"], p["up"], p["down"],
        cfg, SerialComm(), tp_comm=mesh.comm("model"))
    return {"y": y, "aux": aux, **stats}


def mesh_serve(comm, weights: dict) -> dict:
    """Every mesh run of this world's size (:data:`MESH_RUNS`) on the
    bridged ``weights`` (numpy trees by arch), the per-call check at tp 2
    and the split MoE block; one thread a rank."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.core.comm import make_mesh
    from repro_torch.models.api import build_model
    torch.set_num_threads(1)
    n = comm.size()
    meshes, models, params, out = {}, {}, {}, {}
    for case, shape, names in MESH_RUNS[n]:
        arch = MESH_CASES[case][0]
        if arch not in models:
            models[arch] = model = build_model(mesh_config(arch))
            params[arch] = params_from_numpy(weights[arch], device="cpu",
                                             defs=model.param_defs())
        if (shape, names) not in meshes:    # every rank, in the same order
            meshes[shape, names] = make_mesh(shape, names)
        out[case, shape] = _serve_case(models[arch], params[arch],
                                       meshes[shape, names], case)
    mesh = meshes[(n,), TP]
    if n == 2:
        model, p = models["qwen2-7b"], params["qwen2-7b"]
        out["percall"] = _percall(model, p, mesh)
        out["disagg"] = _disagg(model, p, mesh)
        out["traffic-wall"] = _traffic_wall(model, p, mesh)
        out["expert-tp"] = _moe_expert_tp(mesh)
    out["block", (n,)] = _moe_blocks(mesh)
    if n == 4:
        out["block", (2, 2)] = _moe_blocks(meshes[(2, 2), EP])
    return out


# llava's SMOKE VLM (4 query / 2 KV heads) under a serving mesh: image and
# text requests through Megatron TP of the paged path
VLM_KW = dict(max_slots=2, max_len=64, page_size=8, prefill_chunk=8)


def vlm_mesh_serve(comm, weights, requests) -> dict:
    """The ``requests`` ((prompt, image or None, max_new) each) on a
    ``("model",)`` mesh of the whole world, on the bridged ``weights``: the
    streams and the prefix-cache hits."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import smoke_config
    from repro_torch.core.comm import make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import ServeEngine
    torch.set_num_threads(1)
    model = build_model(smoke_config("llava-next-mistral-7b"))
    params = params_from_numpy(weights, device="cpu")
    mesh = make_mesh((comm.size(),), ("model",))
    eng = ServeEngine(model, params, mesh=mesh, device="cpu", **VLM_KW)
    for prompt, image, n in requests:
        kw = {} if image is None else {"encoder_input": image}
        eng.submit(prompt, max_new_tokens=n, **kw)
    eng.run_until_drained()
    eng.close()
    if any(r.error is not None for r in eng.finished):
        raise RuntimeError([r.error for r in eng.finished])
    return {"streams": {r.rid: list(r.output) for r in eng.finished},
            "prefix_hits": eng.stats["prefix_hits"], "tp": eng.tp}


# -- training over a mesh (tests/test_torch_mesh_train.py) -------------------
# SMOKE qwen3-1.7b with the reference test's tp=2 (its vocab padding), a
# batch of 8 x 32 (seed 0), the reference test's one-step AdamW, and the
# five-step trainer's
TRAIN_B, TRAIN_S = 8, 32
TRAIN_OPT1 = dict(peak_lr=1e-2, warmup_steps=0, decay_steps=10)
TRAIN_OPT5 = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=5)
POD_OPT = dict(peak_lr=3e-3, warmup_steps=0, decay_steps=20)
POD_STEPS = 8
TRAIN_MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}
POD_MESHES = [(2, 2, 1), (2, 1, 2)]
CKPT_STEP = 1                   # the elastic resume's checkpoint
DM = ("data", "model")
PDM = ("pod", "data", "model")


def train_model():
    from repro_torch.configs import smoke_config
    from repro_torch.models.api import build_model
    return build_model(smoke_config("qwen3-1.7b").replace(tp=2))


def train_task(cfg):
    from repro_torch.data import SyntheticTask
    return SyntheticTask(cfg, batch=TRAIN_B, seq_len=TRAIN_S)


def _gathered(tree, specs, mesh, keep: bool):
    """Every leaf of a sharded tree whole (a collective of every rank), as
    numpy on the rank that ``keep``s it."""
    from repro_torch.mesh.grad_comm import gather
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _gathered(v, specs[k], mesh, keep)
        else:
            with torch.no_grad():
                w = gather(v, specs[k], mesh)
            out[k] = w.detach().numpy().copy() if keep else None
    return out


def _train_case(mesh, weights, ckpt_dir=None) -> dict:
    """One mesh's training checks: a step (lr 1e-2), the same with two
    microbatches, the eval loss, the seeded sharded init gathered, five
    trainer steps (checkpointing every step into ``ckpt_dir``)."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.data import make_batch_fn, make_data_iter
    from repro_torch.mesh.axes import rules_for_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (Trainer, TrainerConfig,
                                   create_train_state, make_eval_step,
                                   make_train_step)
    from repro_torch.train.step import train_mesh
    model = train_model()
    rules = rules_for_mesh(mesh)
    tm = train_mesh(model, mesh, rules)
    keep = mesh.world.rank() == 0
    params = params_from_numpy(weights, device="cpu",
                               defs=model.param_defs())
    task = train_task(model.cfg)
    specs = model.train_batch_specs(type("S", (), {
        "global_batch": TRAIN_B, "seq_len": TRAIN_S})())
    batch = make_batch_fn(task, mesh, rules, specs)(0)
    out = {}
    opt1 = AdamWConfig(**TRAIN_OPT1)
    for accum in (1, 2):
        st = create_train_state(model, 0, opt1, mesh, rules, device="cpu",
                                params=params)
        _, m = make_train_step(model, opt1, mesh, rules,
                               accum_steps=accum)(st, batch)
        out["step", accum] = {
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": _gathered(st["params"], tm.specs, mesh, keep),
            "m": _gathered(st["opt"]["m"], tm.specs, mesh, keep)}
    st = create_train_state(model, 0, opt1, mesh, rules, device="cpu",
                            params=params)
    out["eval"] = float(make_eval_step(model, mesh, rules)(
        st["params"], batch)["loss"])
    st = create_train_state(model, 0, opt1, mesh, rules, device="cpu")
    out["init"] = _gathered(st["params"], tm.specs, mesh, keep)
    tr = Trainer(model, AdamWConfig(**TRAIN_OPT5),
                 TrainerConfig(steps=5, log_every=100, ckpt_dir=ckpt_dir,
                               ckpt_every=1, ckpt_keep=5),
                 make_data_iter(task, mesh, rules, specs, device="cpu"),
                 mesh=mesh, rules=rules, device="cpu", params=params,
                 log=lambda s: None)
    out["history"] = tr.fit()["history"]
    out["final"] = _gathered(tr.final_state["params"], tm.specs, mesh, keep)
    return out


def _resume(mesh, ckpt_dir) -> dict:
    """The loss of the step after the checkpoint at CKPT_STEP, restored
    onto ``mesh``'s shards; whether ``reshard_state`` of the checkpoint
    restored whole gives the same shards."""
    from repro_torch.data import make_batch_fn
    from repro_torch.mesh.axes import rules_for_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.models.module import tree_leaves
    from repro_torch.train import (create_train_state, make_train_step,
                                   reshard_state, restore_checkpoint,
                                   state_shardings)
    model = train_model()
    rules = rules_for_mesh(mesh)
    opt = AdamWConfig(**TRAIN_OPT5)
    like = create_train_state(model, 0, opt, mesh, rules, device="cpu")
    sh = state_shardings(model, mesh, rules)
    st, step = restore_checkpoint(ckpt_dir, like, step=CKPT_STEP,
                                  shardings=sh)
    # the same checkpoint restored whole, then resharded onto the mesh
    whole, _ = restore_checkpoint(ckpt_dir, create_train_state(
        model, 0, opt, device="cpu"), step=CKPT_STEP)
    again = reshard_state(whole, sh)
    same = all(torch.equal(a, b) and a.requires_grad == b.requires_grad
               for a, b in zip(tree_leaves(again), tree_leaves(st)))
    specs = model.train_batch_specs(type("S", (), {
        "global_batch": TRAIN_B, "seq_len": TRAIN_S})())
    batch = make_batch_fn(train_task(model.cfg), mesh, rules, specs)(step)
    _, m = make_train_step(model, opt, mesh, rules)(st, batch)
    return {"loss": float(m["loss"]), "resharded_equal": same}


def _nan_guard(mesh, ckpt_dir) -> dict:
    """NaN on every rank: each rolls back to the newest checkpoint, its
    shard of the embedding table that checkpoint's."""
    from repro_torch.mesh.axes import rules_for_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import NanGuard, create_train_state, state_shardings
    model = train_model()
    rules = rules_for_mesh(mesh)
    sh = state_shardings(model, mesh, rules)
    like = create_train_state(model, 0, AdamWConfig(**TRAIN_OPT5), mesh,
                              rules, device="cpu")
    guard = NanGuard(ckpt_dir, sh, max_rollbacks=1)
    healthy = guard.check(torch.tensor(1.5), like) is None
    state, step, skip = guard.check(torch.tensor(float("nan")), like)
    return {"healthy": healthy, "step": step, "skip": skip,
            "table": state["params"]["embed"]["table"].detach().numpy(),
            "spec": sh["params"]["embed"]["table"].spec,
            "coords": dict(mesh.coords)}


def _pod_dp(mesh, weights) -> dict:
    """POD_STEPS pod data-parallel steps, compressed and not, from the
    bridged weights; each pod's first param leaf gathered whole."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.optim import AdamWConfig
    from repro_torch.mesh.axes import rules_for_mesh
    from repro_torch.mesh.grad_comm import gather
    from repro_torch.train.pod_dp import make_pod_dp_step
    from repro_torch.train.pod_dp import split_pod_meshes
    model = train_model()
    rules = rules_for_mesh(mesh)
    params = params_from_numpy(weights, device="cpu",
                               defs=model.param_defs())
    task = train_task(model.cfg)
    out = {"pods": [(p.pod, p.member, p.shape, p.world and p.world.size())
                    for p in split_pod_meshes(mesh)]}
    for compress in (True, False):
        step = make_pod_dp_step(model, AdamWConfig(**POD_OPT), mesh, rules,
                                compress=compress)
        state = step.init_state(0, device="cpu", params=params)
        outs = []
        for i in range(POD_STEPS):
            state, o = step(state, task.batch_at(i))
            outs.append(o)
        spec = step.tm.specs["embed"]["table"]
        with torch.no_grad():
            table = gather(state["params"]["embed"]["table"], spec, mesh)
        out[compress] = {"outs": outs,
                         "table": table.detach().numpy().copy()}
    return out


def _psum_input(rank: int, n_leaves: int = 3) -> dict:
    rng = np.random.default_rng((SEED, rank, 7))
    shapes = [(5, 7), (33,), (4, 3, 2)][:n_leaves]
    return {f"g{i}": rng.normal(size=s).astype(np.float32) * (i + 1)
            for i, s in enumerate(shapes)}


def _psum(comm) -> dict:
    """compressed_psum twice on this rank's input (the second call with
    the first's residual, the same gradient)."""
    from repro_torch.optim.compress import (compressed_psum,
                                            init_compression_state)
    g = {k: torch.from_numpy(v) for k, v in _psum_input(comm.rank()).items()}
    err = init_compression_state(g)["err"]
    mean1, err = compressed_psum(g, err, comm)
    mean2, err2 = compressed_psum(g, err, comm)
    return {"mean1": mean1, "err1": err, "mean2": mean2, "err2": err2}


def mesh_train(comm, weights, ckpt_dir, resume_dir=None) -> dict:
    """Every training check of this world's size on the bridged
    ``weights``: TRAIN_MESHES' cases, compressed_psum; at world 4 the (2,
    2) run checkpoints into ``ckpt_dir``, NanGuard rolls back, and the pod
    meshes train; at world 2 the (2, 1) mesh resumes from ``resume_dir``
    (world 4's checkpoint).  One thread a rank."""
    from repro_torch.core.comm import make_mesh
    torch.set_num_threads(1)
    n = comm.size()
    out = {"psum": _psum(comm)}
    for shape in TRAIN_MESHES[n]:
        mesh = make_mesh(shape, DM)
        out["train", shape] = _train_case(
            mesh, weights, ckpt_dir if n == 4 else None)
        if n == 4:
            out["nan"] = _nan_guard(mesh, ckpt_dir)
        if resume_dir is not None and shape == (2, 1):
            out["resume"] = _resume(mesh, resume_dir)
    if n == 4:
        for shape in POD_MESHES:
            out["pod", shape] = _pod_dp(make_mesh(shape, PDM), weights)
    return out


# -- ring attention and the pipeline (tests/test_torch_mesh_parallel.py) ------
RING = dict(B=2, S=64, Hq=4, Hkv=2, D=32)
PIPE = dict(n_stages=4, n_micro=6, mb=2, d=16)


def ring_inputs():
    rng = np.random.default_rng(0)
    B, S, Hq, Hkv, D = (RING[k] for k in ("B", "S", "Hq", "Hkv", "D"))
    return (rng.normal(size=(B, S, Hq, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, D)).astype(np.float32))


def pipe_inputs():
    rng = np.random.default_rng(0)
    n, m, mb, d = (PIPE[k] for k in ("n_stages", "n_micro", "mb", "d"))
    params = {"w": (rng.normal(size=(n, d, d)) * 0.2).astype(np.float32),
              "b": (rng.normal(size=(n, d)) * 0.1).astype(np.float32)}
    return params, rng.normal(size=(m, mb, d)).astype(np.float32)


def pipe_stage(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def mesh_parallel(comm) -> dict:
    """This rank's block of causal ring attention over the world (an
    ``("sp",)`` mesh), and at world 4 the GPipe forward over ``("pod",)``."""
    from repro_torch.core.comm import make_mesh
    from repro_torch.mesh import pipeline_apply, ring_attention
    torch.set_num_threads(1)
    n, r = comm.size(), comm.rank()
    mesh = make_mesh((n,), ("sp",))
    s = RING["S"] // n
    q, k, v = (torch.from_numpy(a[:, r * s:(r + 1) * s])
               for a in ring_inputs())
    out = {"ring": ring_attention(q, k, v, mesh.comm("sp"), causal=True)}
    if n == PIPE["n_stages"]:
        params, x = pipe_inputs()
        pmesh = make_mesh((n,), ("pod",))
        out["pipe"] = pipeline_apply(
            pipe_stage, {k: torch.from_numpy(a) for k, a in params.items()},
            torch.from_numpy(x), pmesh, axis="pod")
    return out


# -- MoE training over a mesh (tests/test_torch_moe_train.py) -----------------
# SMOKE qwen3-moe (8 experts, top 4; tp 2, as the dense mesh tests) on
# ("data", "model") meshes, the experts split over "model"; capacity factor
# 8.0, so that no rank's capacity drops a token, for the step and the
# trainer; the block alone at the config's own 1.25, MOE_BLOCK_T tokens a
# rank, where tokens drop
MOE_ARCH = "qwen3-moe-235b-a22b"
MOE_TRAIN_MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2)]}
MOE_TRAIN_CF = 8.0
MOE_BLOCK_T = 24


def moe_train_model(capacity_factor: float = MOE_TRAIN_CF):
    from repro_torch.configs import smoke_config
    from repro_torch.models.api import build_model
    return build_model(smoke_config(MOE_ARCH).replace(
        tp=2, capacity_factor=capacity_factor))


def moe_block_tokens(rank: int, d: int) -> np.ndarray:
    """World rank ``rank``'s tokens for the block alone."""
    rng = np.random.default_rng((SEED, 41, rank))
    return rng.normal(size=(MOE_BLOCK_T, d)).astype(np.float32)


def _moe_block_alone(mesh, tm, weights) -> dict:
    """Layer 0's MoE block on this rank's tokens at the config's capacity
    factor, its experts this rank's E/tp over the expert axis: y, aux and
    the telemetry."""
    from repro_torch.models import moe as M
    cfg = moe_train_model(1.25).cfg
    w = {k: torch.from_numpy(v[0]) for k, v in
         weights["blocks"]["moe"].items()}
    ec = tm.expert_comm()
    e_loc = cfg.n_experts // ec.size()
    lo = ec.rank() * e_loc
    x = torch.from_numpy(moe_block_tokens(mesh.world.rank(), cfg.d_model))
    with torch.no_grad():
        y, aux, stats = M._dispatch_compute_combine(
            x, w["router"], *(w[k][lo:lo + e_loc] for k in ("gate", "up",
                                                           "down")),
            cfg, ec)
    return {"y": y, "aux": float(aux), **stats}


def _moe_train_case(mesh, weights) -> dict:
    """One mesh's MoE training checks: one step's loss, ce, aux and every
    gradient leaf gathered whole, five trainer steps, the seeded sharded
    init gathered, the block alone."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.data import make_batch_fn, make_data_iter
    from repro_torch.mesh.axes import rules_for_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig, create_train_state
    from repro_torch.train.step import make_grads_fn, train_mesh
    model = moe_train_model()
    rules = rules_for_mesh(mesh)
    tm = train_mesh(model, mesh, rules)
    keep = mesh.world.rank() == 0
    params = params_from_numpy(weights, device="cpu",
                               defs=model.param_defs())
    task = train_task(model.cfg)
    specs = model.train_batch_specs(type("S", (), {
        "global_batch": TRAIN_B, "seq_len": TRAIN_S})())
    batch = make_batch_fn(task, mesh, rules, specs)(0)
    opt = AdamWConfig(**TRAIN_OPT5)
    st = create_train_state(model, 0, opt, mesh, rules, device="cpu",
                            params=params)
    loss, met, grads = make_grads_fn(model, tm)(st["params"], batch)
    tm.finish_grads(grads)
    out = {"step": {"loss": float(loss),
                    **{k: float(v) for k, v in met.items()},
                    "grads": _gathered(grads, tm.specs, mesh, keep)}}
    tr = Trainer(model, opt, TrainerConfig(steps=5, log_every=100),
                 make_data_iter(task, mesh, rules, specs, device="cpu"),
                 mesh=mesh, rules=rules, device="cpu", params=params,
                 log=lambda s: None)
    out["history"] = tr.fit()["history"]
    st = create_train_state(model, 0, opt, mesh, rules, device="cpu")
    out["init"] = _gathered(st["params"], tm.specs, mesh, keep)
    out["block"] = _moe_block_alone(mesh, tm, weights)
    return out


def moe_train(comm, weights) -> dict:
    """MOE_TRAIN_MESHES' cases of this world's size on the bridged SMOKE
    ``weights``; one thread a rank."""
    from repro_torch.core.comm import make_mesh
    torch.set_num_threads(1)
    return {shape: _moe_train_case(make_mesh(shape, DM), weights)
            for shape in MOE_TRAIN_MESHES[comm.size()]}


# -- rwkv6 and zamba2 training over a mesh (tests/test_torch_recurrent_mesh.py)
REC_ARCHS = ("rwkv6-3b", "zamba2-7b")
REC_MESHES = {2: [(1, 2), (2, 1)], 4: [(2, 2), (1, 4)]}
# tests/test_torch_recurrent_train.py's batches: 4 x 32 from seed 2, on
# which the one-device trainers of both families meet the reference's
# five steps
REC_B, REC_SEED = 4, 2
# the exchanges alone: (B, S, H, C) of the tensors each rank blocks over
# the sequence, and the rows prev_rows sends on
EXCHANGE = dict(B=2, S=8, H=4, C=3, n=2)


def rec_model(arch: str):
    from repro_torch.configs import smoke_config
    from repro_torch.models.api import build_model
    return build_model(smoke_config(arch))


def rec_task(cfg):
    from repro_torch.data import SyntheticTask
    return SyntheticTask(cfg, batch=REC_B, seq_len=TRAIN_S, seed=REC_SEED)


def _rec_specs(model):
    return model.train_batch_specs(type("S", (), {
        "global_batch": REC_B, "seq_len": TRAIN_S})())


def exchange_inputs():
    """The exchanges' whole tensors, the same on every rank: two inputs
    (B, S, H, C), one float32 and one float64 (two dtypes: two
    collectives), and the cotangents of what each exchange returns."""
    rng = np.random.default_rng((SEED, 43))
    B, S, H, C, n = (EXCHANGE[k] for k in "BSHCn")
    return {"x": rng.normal(size=(B, S, H, C)).astype(np.float32),
            "z": rng.normal(size=(B, S, H, C)),
            "g_heads": rng.normal(size=(B, S, H, C)).astype(np.float32),
            "g_prev": rng.normal(size=(B, S, H * C)).astype(np.float32)}


def _exchanges(tm) -> dict:
    """prev_rows and seq_to_heads -> heads_to_seq on this rank's block of
    :func:`exchange_inputs`, forward and gradient: what the test holds
    against their serial composition."""
    ins = exchange_inputs()
    i, nb = tm.seq_block()
    S, n = EXCHANGE["S"], EXCHANGE["n"]
    s = S // nb
    x = torch.from_numpy(ins["x"][:, i * s:(i + 1) * s]).requires_grad_(True)
    z = torch.from_numpy(ins["z"][:, i * s:(i + 1) * s]).requires_grad_(True)
    xh, zh = tm.seq_to_heads(x, z)
    h = xh.shape[2]
    back, = tm.heads_to_seq(xh)
    g = torch.from_numpy(ins["g_heads"][:, :, i * h:(i + 1) * h])
    (xh * g).sum().backward()
    out = {"heads": xh.detach().clone(), "z_heads": zh.detach().clone(),
           "back": back.detach().clone(), "d_heads": x.grad.clone()}
    flat = [t.detach().reshape(t.shape[0], s, -1).requires_grad_(True)
            for t in (x, z)]
    prev = tm.prev_rows(flat, n)
    gp = torch.from_numpy(ins["g_prev"][:, i * n:(i + 1) * n])
    (prev[0] * gp).sum().backward()
    out.update({"prev": prev[0].detach().clone(),
                "z_prev": prev[1].detach().clone(),
                "d_prev": flat[0].grad.clone()})
    return out


@contextlib.contextmanager
def first_step_grads(finish):
    """Within it, the first AdamW update that ``make_train_step``'s steps
    run records ``finish(grads)`` of the gradients it is handed (on a
    mesh: after ``finish_grads``) in the yielded dict under ``"grads"``:
    a trainer's first step gives the one-step check its gradients."""
    import repro_torch.train.step as S
    inner, out = S.adamw_update, {}

    def spy(params, grads, *args, **kwargs):
        if "grads" not in out:
            out["grads"] = finish(grads)
        return inner(params, grads, *args, **kwargs)
    S.adamw_update = spy
    try:
        yield out
    finally:
        S.adamw_update = inner


def _trainer_case(mesh, model, task, specs, weights, steps: int) -> dict:
    """``steps`` trainer steps of ``model`` on ``mesh`` from its bridged
    ``weights`` and ``task``'s batches cut by ``specs``; the first step's
    loss and every gradient leaf gathered whole (rank 0 keeps them)."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.data import make_data_iter
    from repro_torch.mesh.axes import rules_for_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.step import train_mesh
    rules = rules_for_mesh(mesh)
    tm = train_mesh(model, mesh, rules)
    keep = mesh.world.rank() == 0
    params = params_from_numpy(weights, device="cpu",
                               defs=model.param_defs())
    tr = Trainer(model, AdamWConfig(**TRAIN_OPT5),
                 TrainerConfig(steps=steps, log_every=100),
                 make_data_iter(task, mesh, rules, specs, device="cpu"),
                 mesh=mesh, rules=rules, device="cpu", params=params,
                 log=lambda s: None)
    with first_step_grads(lambda g: _gathered(g, tm.specs, mesh,
                                              keep)) as first:
        history = tr.fit()["history"]
    return {"history": history, "grads": first["grads"]}


def _rec_case(mesh, arch, weights) -> dict:
    """One mesh's checks of ``arch``: five trainer steps, the first
    step's loss and every gradient leaf gathered whole."""
    model = rec_model(arch)
    return _trainer_case(mesh, model, rec_task(model.cfg), _rec_specs(model),
                         weights, 5)


def recurrent_mesh(comm, weights) -> dict:
    """REC_MESHES' cases of this world's size, both families on their
    bridged SMOKE ``weights`` (by arch), and each mesh's exchanges alone;
    one thread a rank."""
    from repro_torch.core.comm import make_mesh
    from repro_torch.mesh.axes import rules_for_mesh
    from repro_torch.train.step import train_mesh
    torch.set_num_threads(1)
    out = {}
    for shape in REC_MESHES[comm.size()]:
        mesh = make_mesh(shape, DM)
        tm = train_mesh(rec_model(REC_ARCHS[0]), mesh, rules_for_mesh(mesh))
        out[shape, "exchange"] = _exchanges(tm)
        for arch in REC_ARCHS:
            out[shape, arch] = _rec_case(mesh, arch, weights[arch])
    return out


def recurrent_world_one(comm, weights, arch) -> dict:
    """``arch`` at bf16 compute (float32 weights), one step's loss and
    gradients on one device and on a (1, 1) mesh of this one rank, each
    leaf's bits: the layout the card's world-1 phases run."""
    model = rec_model(arch)
    model.cfg = model.cfg.replace(dtype="bfloat16")
    return _world_one(model, rec_task(model.cfg), _rec_specs(model), weights)


def _world_one(model, task, specs, weights) -> dict:
    """One step's ``[loss, *gradient leaves]`` of ``model`` on
    ``task``'s batch 0 from its bridged ``weights``, on one device
    (``False``) and on a (1, 1) mesh of this one rank (``True``).  One
    thread (restored after): the caller's process runs it, beside other
    test processes."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.core.comm import make_mesh
    from repro_torch.data import make_batch_fn
    from repro_torch.mesh.axes import rules_for_mesh
    from repro_torch.models.module import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import create_train_state
    from repro_torch.train.step import make_grads_fn, train_mesh
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mesh = make_mesh((1, 1), DM)
        rules = rules_for_mesh(mesh)
        tm = train_mesh(model, mesh, rules)
        out = {}
        for meshed in (False, True):
            params = params_from_numpy(weights, device="cpu",
                                       defs=model.param_defs())
            if meshed:
                params = create_train_state(
                    model, 0, AdamWConfig(**TRAIN_OPT5), mesh, rules,
                    device="cpu", params=params)["params"]
                batch = make_batch_fn(task, mesh, rules, specs)(0)
                loss, _, grads = make_grads_fn(model, tm)(params, batch)
                tm.finish_grads(grads)
            else:
                params = tree_map(lambda t: t.requires_grad_(True), params)
                loss, _, grads = make_grads_fn(model)(params,
                                                      task.batch_at(0))
            out[meshed] = [loss] + list(tree_leaves(grads))
        return out
    finally:
        torch.set_num_threads(threads)


# -- llava and whisper training over a mesh
# (tests/test_torch_multimodal_train.py)
MM_ARCHS = ("llava-next-mistral-7b", "whisper-tiny")
MM_MESH = (2, 2)
# 4 rows of 24 positions from seed 2: llava SMOKE's 8 image rows and 16
# text tokens, so at tp 2 the first block of 12 is 8 image rows and 4 text
# rows (it straddles the boundary) and the second 12 text rows
MM_B, MM_S, MM_SEED, MM_STEPS = 4, 24, 2, 3


def mm_model(arch: str):
    from repro_torch.configs import smoke_config
    from repro_torch.models.api import build_model
    return build_model(smoke_config(arch))


def mm_task(cfg):
    from repro_torch.data import SyntheticTask
    return SyntheticTask(cfg, batch=MM_B, seq_len=MM_S, seed=MM_SEED)


def mm_specs(model):
    return model.train_batch_specs(type("S", (), {
        "global_batch": MM_B, "seq_len": MM_S})())


def multimodal_mesh(comm, weights) -> dict:
    """Both families' MM_STEPS trainer steps on a MM_MESH ("data",
    "model") mesh of this world from their bridged SMOKE ``weights`` (by
    arch), the first step's gradients gathered whole; one thread a rank."""
    from repro_torch.core.comm import make_mesh
    torch.set_num_threads(1)
    mesh = make_mesh(MM_MESH, DM)
    out = {}
    for arch in MM_ARCHS:
        model = mm_model(arch)
        out[arch] = _trainer_case(mesh, model, mm_task(model.cfg),
                                  mm_specs(model), weights[arch], MM_STEPS)
    return out


def multimodal_world_one(comm, weights, arch) -> dict:
    """``arch`` at bf16 compute (float32 weights): :func:`_world_one`, the
    card's world-1 layout."""
    model = mm_model(arch)
    model.cfg = model.cfg.replace(dtype="bfloat16")
    return _world_one(model, mm_task(model.cfg), mm_specs(model), weights)
