"""Device time of flash attention's tensor-core kernels, kernel by kernel.

    PYTHONPATH=src python -m repro_torch.launch.flash_timing

On one card: the backward at training's shape (qwen3-1.7b: B 4, S 2048,
16/8 heads of 128, causal, bf16) as a whole call by CUDA events and each
of its three launches (delta, dq, dk/dv) by ``torch.profiler``, beside
SDPA's backward with ``is_causal``; and the forward at gemma3's prefill
shape (B 4, S 2048, 8/4 heads of 256, window 1024 and global) beside
SDPA.  Each timed shape is first held against the plain version (the
backward's gradients within 2e-2 of the largest magnitude, the forward
within 4e-3).  Prints the card's name and power limit, one line a
measurement and, last, one JSON object.
A card is required: there is no CPU measurement.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as FA

BWD_SHAPE = (4, 2048, 16, 8, 128)          # B, S, Hq, Hkv, D
FWD_SHAPE = (4, 2048, 8, 4, 256)
FWD_WINDOWS = (1024, None)
BWD_REL, FWD_TOL = 2e-2, 4e-3


def _event_ms(fn, iters: int, warmup: int = 5) -> float:
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


def _kernel_name(key: str) -> str:
    found = re.search(r"(\w+_kernel)\b", key)
    return found.group(1) if found else key[:60]


def _inputs(B, S, Hq, Hkv, D):
    dev = torch.device("cuda")
    q, g = (torch.randn(B, S, Hq, D, device=dev).bfloat16() for _ in range(2))
    k, v = (torch.randn(B, S, Hkv, D, device=dev).bfloat16()
            for _ in range(2))
    return q, k, v, g


def _check_backward(q, k, v, g, out, lse) -> float:
    got = FA.flash_attention_bwd_cuda(q, k, v, out, g, lse=lse)
    leaves = [t.float().requires_grad_(True) for t in (q[:1], k[:1], v[:1])]
    want = torch.autograd.grad(FA.flash_attention_plain(*leaves), leaves,
                               g[:1].float())
    rel = max((a[:1].float() - b).abs().max().item()
              / max(1.0, b.abs().max().item()) for a, b in zip(got, want))
    if rel > BWD_REL:
        raise AssertionError(f"flash_timing: backward {rel} > {BWD_REL}")
    return rel


def measure_backward(iters: int) -> dict:
    q, k, v, g = _inputs(*BWD_SHAPE)
    out, lse = FA.flash_attention_cuda(q, k, v, with_lse=True)
    rel = _check_backward(q, k, v, g, out, lse)
    call = _event_ms(lambda: FA.flash_attention_bwd_cuda(q, k, v, out, g,
                                                         lse=lse), iters)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            FA.flash_attention_bwd_cuda(q, k, v, out, g, lse=lse)
        torch.cuda.synchronize()
    # profiler keys read "void (anonymous namespace)::tc::<name><D>(...)"
    kernels = {_kernel_name(e.key): e.device_time_total / e.count / 1e3
               for e in prof.key_averages() if e.device_time_total > 0}
    leaves = [t.transpose(1, 2).detach().requires_grad_(True)
              for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                             enable_gqa=True)
    lib = _event_ms(lambda: torch.autograd.grad(
        lib_out, leaves, g.transpose(1, 2), retain_graph=True), iters)
    return {"shape": list(BWD_SHAPE), "max_rel_err": rel, "ms": call,
            "kernels_ms": kernels, "sdpa_is_causal_ms": lib}


def measure_forward(iters: int) -> dict:
    q, k, v, _ = _inputs(*FWD_SHAPE)
    res = {}
    for window in FWD_WINDOWS:
        got = FA.flash_attention_cuda(q[:1], k[:1], v[:1], window=window)
        want = FA.flash_attention_plain(q[:1], k[:1], v[:1], window=window)
        if not torch.allclose(got.float(), want.float(), rtol=FWD_TOL,
                              atol=FWD_TOL):
            raise AssertionError(f"flash_timing: D 256 window={window}")
        ms = _event_ms(lambda: FA.flash_attention_cuda(q, k, v,
                                                       window=window), iters)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if window is None:
            sdpa = _event_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), iters)
        else:
            pos = torch.arange(q.shape[1], device=q.device)
            mask = ((pos[:, None] >= pos[None, :])
                    & (pos[:, None] - pos[None, :] < window))
            sdpa = _event_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True), iters)
        res[f"window={window}"] = {"ms": ms, "sdpa_ms": sdpa}
    return {"shape": list(FWD_SHAPE), **res}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_timing: no CUDA device is visible")
    torch.manual_seed(0)
    # the card's name and power limit, to stand beside every number
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    print(f"[flash_timing] {smi.strip().splitlines()[0]}")
    result = {"device": torch.cuda.get_device_name(0),
              "nvidia_smi": smi.strip().splitlines()[0],
              "backward": measure_backward(args.iters),
              "forward_d256": measure_forward(args.iters)}
    b = result["backward"]
    print(f"[flash_timing] backward {b['shape']}: {b['ms']:.4f} ms a call "
          f"({', '.join(f'{n} {t:.4f}' for n, t in b['kernels_ms'].items())}"
          f" ms), SDPA is_causal {b['sdpa_is_causal_ms']:.4f} ms, max rel "
          f"err {b['max_rel_err']:.5f}")
    for name, r in result["forward_d256"].items():
        if name != "shape":
            print(f"[flash_timing] forward D 256 {name}: {r['ms']:.4f} ms, "
                  f"SDPA {r['sdpa_ms']:.4f} ms")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
