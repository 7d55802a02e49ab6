"""Training launcher of the port: one card (or the CPU), no mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --steps 20 --batch 4 --seq 2048

``--smoke`` trains the small config; without it the full-width config
trains on the card (float32 weights and AdamW moments, the config's
compute dtype, ``remat`` full).  The synthetic batches are the
reference's bit for bit (:mod:`repro_torch.data`).  ``--mesh`` other
than ``none`` exits: training over a mesh comes with ROADMAP A13b.  The
summary line is the reference launcher's; a second line gives each
kernel's launches and plain-version calls.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.data import SyntheticTask, make_data_iter
from repro_torch.kernels import ops
from repro_torch.models.api import build_model
from repro_torch.models.module import resolve_device
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer, TrainerConfig


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
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train; returns the trainer's ``{"history", "stragglers"}``."""
    args = parse_args(argv)
    if args.mesh != "none":
        raise SystemExit(f"--mesh {args.mesh}: training over a mesh comes "
                         "with ROADMAP A13b; train on one device with "
                         "--mesh none")
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    dev = resolve_device(args.device)
    task = SyntheticTask(cfg, batch=args.batch, seq_len=args.seq)
    it = make_data_iter(task, device=dev)
    tcfg = TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, accum_steps=args.accum)
    opt = AdamWConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      decay_steps=args.steps)
    ops.reset_counts()
    trainer = Trainer(model, opt, tcfg, it, device=dev)
    result = trainer.fit()
    h = result["history"]
    print(f"[train] {args.arch}: loss {h[0]['loss']:.4f} -> "
          f"{h[-1]['loss']:.4f} over {len(h)} steps; "
          f"stragglers={result['stragglers']}")
    print("[train] kernels: " + " ".join(
        f"{name}: launches={c.kernel} plain={c.plain}"
        for name, c in ops.COUNTS.items() if c.kernel or c.plain))
    return result


if __name__ == "__main__":
    main()
