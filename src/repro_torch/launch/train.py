"""Training launcher of the port: one device, or a mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --steps 20 --batch 4 --seq 2048
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --mesh debug --steps 2

``--smoke`` trains the small config; without it the full-width config
trains on the card (float32 weights and AdamW moments, the config's
compute dtype, ``remat`` full).  Every registered arch trains: the dense
and MoE decoders, llava (``--seq`` counts its image rows: 2880 of them at
full width, so ``--seq`` must exceed that), rwkv6, zamba2 and whisper
(each row a clip of ``n_audio_frames`` frames and ``--seq`` decoder
tokens).  The synthetic batches are the reference's (:mod:`repro_torch.
data`).

``--mesh debug|single|multi`` runs the same train body on every rank of a
``run_ranks`` world (the ranks meet through a file store in
``--store-dir``): ``debug`` is the reference's (4, 2) ``("data",
"model")`` mesh on 8 ranks, ``single`` (16, 16) on 256 and ``multi`` (2,
16, 16) ``("pod", "data", "model")`` on 512.  NCCL with one card a rank on
``--device cuda``; gloo with ``--device cpu``.  A world wider than the
visible cards raises (``run_ranks``): a mesh on the card never falls back
to gloo.  The state is sharded at birth (ZeRO-3 over ``"data"`` and
``"model"``), each rank trains on its block of the batch (rows over
``"data"``, positions over ``"model"``).

The summary line is the reference launcher's (rank 0's history on a
mesh); a mesh run then prints ``[train] mesh: {'data': 4, 'model': 2} on
8 ranks (gloo)``; the last line gives (rank 0's) launches and
plain-version calls of each kernel.
"""
from __future__ import annotations

import argparse
import contextlib
import io

import torch

from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.core import comm as C
from repro_torch.data import SyntheticTask, make_data_iter
from repro_torch.kernels import ops
from repro_torch.models.api import build_model
from repro_torch.models.module import resolve_device
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig

MESH_WORLD = {"debug": 8, "single": 256, "multi": 512}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="none",
                    choices=["none", "debug", "single", "multi"])
    ap.add_argument("--store-dir", default="build/ranks",
                    help="where a --mesh run's ranks meet (a file store)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def train(args, mesh=None, rules=None) -> dict:
    """The train body (this rank's, on ``mesh``): ``{"history",
    "stragglers", "counts"}``, ``counts`` each kernel's (launches, plain
    calls)."""
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    dev = resolve_device(args.device)
    task = SyntheticTask(cfg, batch=args.batch, seq_len=args.seq)
    specs = None if mesh is None else model.train_batch_specs(
        type("S", (), {"global_batch": args.batch, "seq_len": args.seq})())
    it = make_data_iter(task, mesh, rules, specs, device=dev)
    tcfg = TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, accum_steps=args.accum)
    opt = AdamWConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      decay_steps=args.steps)
    ops.reset_counts()
    trainer = Trainer(model, opt, tcfg, it, mesh=mesh, rules=rules,
                      device=dev)
    result = trainer.fit()
    result["counts"] = {name: (c.kernel, c.plain)
                        for name, c in ops.COUNTS.items()
                        if c.kernel or c.plain}
    return result


def train_rank(comm, args) -> dict:
    """One rank of a ``--mesh`` run: make the mesh and train; only rank 0
    prints."""
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
    from repro_torch.mesh.axes import rules_for_mesh
    if args.device == "cpu":
        torch.set_num_threads(1)
    mesh = make_debug_mesh() if args.mesh == "debug" else \
        make_production_mesh(multi_pod=args.mesh == "multi")
    quiet = contextlib.redirect_stdout(io.StringIO()) if comm.rank() \
        else contextlib.nullcontext()
    with quiet:
        result = train(args, mesh, rules_for_mesh(mesh))
    result["mesh"] = dict(mesh.shape)
    return result


def main(argv=None) -> dict:
    """Train; returns the trainer's ``{"history", "stragglers"}`` (rank 0's
    on a mesh, with ``"counts"`` and ``"mesh"``)."""
    args = parse_args(argv)
    if args.mesh == "none":
        result = train(args)
    else:
        result = C.run_ranks(train_rank, (args,),
                             world=MESH_WORLD[args.mesh],
                             store_dir=args.store_dir, device=args.device,
                             timeout=3600)[0]
    h = result["history"]
    print(f"[train] {args.arch}: loss {h[0]['loss']:.4f} -> "
          f"{h[-1]['loss']:.4f} over {len(h)} steps; "
          f"stragglers={result['stragglers']}")
    if args.mesh != "none":
        backend = "nccl" if args.device == "cuda" else "gloo"
        print(f"[train] mesh: {result['mesh']} on {MESH_WORLD[args.mesh]} "
              f"ranks ({backend})")
    print("[train] kernels: " + " ".join(
        f"{name}: launches={k} plain={p}"
        for name, (k, p) in result["counts"].items()))
    return result


if __name__ == "__main__":
    main()
