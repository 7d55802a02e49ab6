"""The two scans' backward kernels on a card, route by route, launch by
launch.

    PYTHONPATH=src python -m repro_torch.launch.scan_timing

On one card: each backward (B4's wkv, B5's SSD) first held on both routes
against autograd through its plain version at small shapes that reach the
hard cases (decays at exact 0 and denormal, a chunk edge and one step past
it, a ragged length, a nonzero initial state and final-state gradient, two
groups of heads), each call run twice for the same bits; then both routes
at the training shapes (main-train-rwkv's B 4, S 2048, H 40, K = V = 64;
main-train-zamba's H 112, N = P = 64; bf16 r/k/v and B/C, no state) as a
whole call by CUDA events, and the tensor-core route launch by launch by
``torch.profiler``.  Prints the card's name and power limit, one line a
measurement and, last, one JSON object.  A card is required: there is no
CPU measurement.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess

import numpy as np
import torch

from repro_torch.kernels import rwkv6_scan as RW
from repro_torch.kernels import ssd_scan as SSD

# max |d| over max(1, max |autograd|): float32 inputs differ by summation
# order only, bf16 ones by one rounding of a gradient to bf16
REL = {torch.float32: 1e-5, torch.bfloat16: 4e-3}
# (B, S, H, zeros and denormals planted in w, with state0 and dsT)
RWKV_CASES = [(2, 64, 2, 0, True), (1, 65, 2, 8, True), (1, 200, 3, 0, True),
              (2, 256, 4, 64, True), (1, 130, 2, 0, False)]
# (B, S, H, with state0 and dsT); B and C bf16 (the tensor-core route)
SSD_CASES = [(1, 64, 2, True), (2, 65, 10, True), (1, 200, 3, True),
             (1, 130, 9, False)]
RWKV_SHAPE = (4, 2048, 40)               # B, S, H at K = V = 64
SSD_SHAPE = (4, 2048, 112)               # B, S, H at N = P = 64


def _event_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _launches_ms(fn, iters: int) -> dict:
    """Mean device ms a call of each kernel ``fn`` launches (a kernel with
    template arguments keeps them: the passes differ only there)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            found = re.search(r"(\w+_kernel(?:<[^>(]*>)?)", e.key)
            name = found.group(1) if found else e.key[:60]
            out[name] = out.get(name, 0.0) + e.device_time_total / iters / 1e3
    return out


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / max(1.0, want.float().abs().max().item())).item()


def _autograd(fn, ins, cots):
    leaves = [None if t is None else t.detach().float().requires_grad_(True)
              for t in ins]
    outs = fn(*leaves)
    torch.autograd.backward(list(outs), list(cots))
    return [None if t is None else t.grad for t in leaves]


def _rwkv_inputs(rng, dtype, B, S, H, planted):
    """rwkv6-3b's statistics: w = exp(-exp(N(0, 1))), with ``planted``
    exact zeros and as many denormals put into it."""
    dev, f = torch.device("cuda"), np.float32
    r, k, v = (torch.from_numpy(rng.normal(size=(B, S, H, 64)).astype(f))
               .to(dev, dtype) for _ in range(3))
    w = np.exp(-np.exp(rng.normal(size=(B, S, H, 64)))).astype(f)
    if planted:
        flat = w.reshape(-1)
        at = rng.choice(flat.size, 2 * planted, replace=False)
        flat[at[:planted]] = 0.0
        flat[at[planted:]] = rng.uniform(1e-45, 1e-39, planted).astype(f)
    u = torch.from_numpy(rng.normal(size=(H, 64)).astype(f)).to(dev)
    return r, k, v, torch.from_numpy(w).to(dev), u


def _ssd_inputs(rng, B, S, H):
    """zamba2's init statistics: dt = softplus(N(0, 1)), la = -dt, xdt =
    N(0, 1) dt, B and C bf16."""
    dev, f = torch.device("cuda"), np.float32
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H))))
    xdt = torch.from_numpy((rng.normal(size=(B, S, H, 64)) * dt[..., None])
                           .astype(f)).to(dev)
    la = torch.from_numpy((-dt).astype(f)).to(dev)
    bm, cm = (torch.from_numpy(rng.normal(size=(B, S, 64)).astype(f))
              .to(dev, torch.bfloat16) for _ in range(2))
    return xdt, la, bm, cm


def _check(what, bwd, plain, ins, dy, dsT, dtype) -> float:
    """Both routes of ``bwd`` against autograd through ``plain`` (the
    final state's cotangent ``dsT``, None: zero), each call run twice for
    the same bits; raises past REL[dtype]."""
    B, H = dy.shape[0], dy.shape[2]
    cot = torch.zeros(B, H, 64, 64, device=dy.device) if dsT is None else dsT
    want = _autograd(plain, ins, (dy, cot))
    worst = 0.0
    for tc in (True, False):
        got, again = (bwd(*ins, dy, dsT, tensor_cores=tc) for _ in range(2))
        if not all(a is None and b is None or torch.equal(a, b)
                   for a, b in zip(got, again)):
            raise AssertionError(f"scan_timing: {what} tc={tc}: two runs "
                                 "differ")
        for g, w in zip(got, want):
            if w is not None:
                rel = _rel(g, w)
                if rel > REL[dtype]:
                    raise AssertionError(f"scan_timing: {what} tc={tc}: "
                                         f"{rel} > {REL[dtype]}")
                worst = max(worst, rel)
    return worst


def check_rwkv() -> dict:
    rng = np.random.default_rng(30)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for B, S, H, planted, state in RWKV_CASES:
            r, k, v, w, u = _rwkv_inputs(rng, dtype, B, S, H, planted)
            dev = r.device
            s0 = torch.randn(B, H, 64, 64, device=dev) if state else None
            dsT = torch.randn(B, H, 64, 64, device=dev) if state else None
            dy = torch.randn(B, S, H, 64, device=dev)
            what = f"rwkv6 B={B} S={S} H={H} planted={planted} {dtype}"
            out[what] = _check(what, RW.rwkv6_scan_bwd_cuda,
                               RW.rwkv6_scan_plain, (r, k, v, w, u, s0), dy,
                               dsT, dtype)
    return out


def check_ssd() -> dict:
    rng = np.random.default_rng(31)
    out = {}
    for B, S, H, state in SSD_CASES:
        xdt, la, bm, cm = _ssd_inputs(rng, B, S, H)
        dev = xdt.device
        s0 = torch.randn(B, H, 64, 64, device=dev) if state else None
        dsT = torch.randn(B, H, 64, 64, device=dev) if state else None
        dy = torch.randn(B, S, H, 64, device=dev)
        what = f"ssd B={B} S={S} H={H}"
        out[what] = _check(what, SSD.ssd_scan_bwd_cuda, SSD.ssd_scan_plain,
                           (xdt, la, bm, cm, s0), dy, dsT, torch.bfloat16)
    return out


def measure(iters: int) -> dict:
    rng = np.random.default_rng(32)
    B, S, H = RWKV_SHAPE
    r, k, v, w, u = _rwkv_inputs(rng, torch.bfloat16, B, S, H, 0)
    dy = torch.randn(B, S, H, 64, device=r.device)
    res = {"rwkv6": {"shape": list(RWKV_SHAPE) + [64, 64]}}
    for tc in (True, False):
        res["rwkv6"]["tc_ms" if tc else "cuda_core_ms"] = _event_ms(
            lambda: RW.rwkv6_scan_bwd_cuda(r, k, v, w, u, None, dy,
                                           tensor_cores=tc), iters)
    res["rwkv6"]["tc_launches_ms"] = _launches_ms(
        lambda: RW.rwkv6_scan_bwd_cuda(r, k, v, w, u, None, dy), iters)
    del r, k, v, w, u, dy
    B, S, H = SSD_SHAPE
    xdt, la, bm, cm = _ssd_inputs(rng, B, S, H)
    dy = torch.randn(B, S, H, 64, device=xdt.device)
    res["ssd"] = {"shape": list(SSD_SHAPE) + [64, 64]}
    for tc in (True, False):
        res["ssd"]["tc_ms" if tc else "cuda_core_ms"] = _event_ms(
            lambda: SSD.ssd_scan_bwd_cuda(xdt, la, bm, cm, None, dy,
                                          tensor_cores=tc), iters)
    res["ssd"]["tc_launches_ms"] = _launches_ms(
        lambda: SSD.ssd_scan_bwd_cuda(xdt, la, bm, cm, None, dy), iters)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("scan_timing: no CUDA device is visible")
    torch.manual_seed(0)
    # the card's name and power limit, to stand beside every number
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    print(f"[scan_timing] {smi.strip().splitlines()[0]}")
    result = {"device": torch.cuda.get_device_name(0),
              "nvidia_smi": smi.strip().splitlines()[0],
              "parity": {**check_rwkv(), **check_ssd()},
              "timing": measure(args.iters)}
    print(f"[scan_timing] both routes of both backwards against autograd "
          f"through the plain versions, each call twice the same bits: max "
          f"rel {max(result['parity'].values()):.3e}")
    for name, t in result["timing"].items():
        print(f"[scan_timing] {name} backward {t['shape']}: tensor-core "
              f"route {t['tc_ms']:.4f} ms a call ("
              + ", ".join(f"{k} {v:.4f}"
                          for k, v in t["tc_launches_ms"].items())
              + f" ms), CUDA-core route {t['cuda_core_ms']:.4f} ms")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
