"""Host cost of the serving mesh's collectives on one rank.

    PYTHONPATH=src python -m repro_torch.launch.collectives --device cuda

runs one rank (``run_ranks`` at world 1: a real NCCL group on a card, gloo
on ``--device cpu``), makes a ``("model",)`` serving mesh, and prints the
host-issued milliseconds a call (the mean over back-to-back calls, ended
by a device synchronise) of what a tensor-parallel decode step issues: the
``Comm`` all-reduce of a (4, d) activation, the tiled vocab-style gather,
the MoE block's all-to-all of a (128, 4, 4096) dispatch buffer, and the
bare ``torch.distributed.all_reduce``, beside a ``clone`` of the same
activation.  Run it under ``TORCH_NCCL_TRACE_BUFFER_SIZE=0`` to see what
the NCCL flight recorder costs.  The last line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

from repro_torch.core import comm as C


def _host_ms(fn, device, n: int) -> float:
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync()
    return (time.perf_counter() - t0) / n * 1e3


def measure(comm, device, d: int = 5120, calls: int = 100) -> dict:
    """The rank body: host-issued ms a call of each collective."""
    device = torch.device(device)
    c = C.make_mesh((1,), ("model",)).comm("model")
    x = torch.randn(4, d, device=device).bfloat16()
    buf = torch.randn(128, 4, 4096, device=device).bfloat16()
    cases = {
        "clone (4, d)": lambda: x.clone(),
        "Comm.all_reduce_sum (4, d)": lambda: c.all_reduce_sum(x),
        "Comm.all_gather tiled (4, d)": lambda: c.all_gather(x, axis=-1,
                                                             tiled=True),
        "Comm.all_to_all (128, 4, 4096)": lambda: c.all_to_all(
            buf, split_axis=0, concat_axis=1),
        "dist.all_reduce (4, d)": lambda: dist.all_reduce(x, group=c.group),
    }
    return {name: _host_ms(fn, device, calls) for name, fn in cases.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--calls", type=int, default=100)
    ap.add_argument("--store-dir", default="build/ranks",
                    help="where the rank meets its group (a file store)")
    args = ap.parse_args(argv)
    out = C.run_ranks(measure, (args.device,), world=1,
                      store_dir=args.store_dir, device=args.device,
                      kwargs={"calls": args.calls})[0]
    for name, ms in out.items():
        print(f"[collectives] {name}: {ms:.4f} ms host-issued a call")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
