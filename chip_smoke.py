"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):

1. device   — a CUDA card must be visible; prints its name and power limit.
2. build    — compiles the CUDA kernels from ``src/repro_torch/csrc``.
3. parity   — each kernel against its plain PyTorch version at the main
              path's shapes, with the tolerances printed beside them.
4. small    — the SMOKE qwen2-7b engine (float32) on the card emits the same
              greedy streams as on the CPU: the output agrees with a
              reference on a small input.
5. main     — full-width, full-depth qwen2-7b (28 layers, bf16, seeded
              random weights) through the serving launcher: 8 requests
              sharing a 256-token prefix, 32 new tokens each; every request
              must finish, both kernels must launch, their plain versions
              must not, and the prefix cache must hit.
6. timing   — each kernel, its plain version and one PyTorch yardstick call
              timed at the main path's decode shapes (device time from a
              replayed CUDA graph; the host-issued time printed beside),
              beside the bytes/operations bound.
7. step     — one decode step and one prefill chunk of the main path's
              model, host-issued and as device time.

The line before the last is the ``{"kernels": [...]}`` record; the last is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.module import tree_map  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# rtol = atol per kernel and dtype.  bf16 rmsnorm outputs are O(1), where
# one bf16 ulp is 2**-7 ~ 8e-3; bf16 attention outputs are ~0.1, and the
# limit sits near twice the largest error seen on the card.
TOL = {"rmsnorm": {torch.float32: 2e-4, torch.bfloat16: 2e-2},
       "paged_attention_mq": {torch.float32: 2e-4, torch.bfloat16: 1e-2}}
PS = 16                            # the main path's page size
MAIN_ARGS = ["--arch", "qwen2-7b", "--requests", "8", "--max-new", "32",
             "--slots", "4", "--max-len", "512", "--page-size", str(PS),
             "--prefill-chunk", "64", "--prefix-cache", "on",
             "--shared-prefix", "256", "--device", "cuda"]


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def time_ms(fn, iters: int = 100, warmup: int = 10) -> float:
    """Mean milliseconds a call of ``fn`` takes as the host issues it: CUDA
    events around back-to-back calls, so when the host is slower than the
    card this measures the host's launch cadence."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fns, reps: int = 20) -> float:
    """Mean device milliseconds a call: ``fns`` (one call each) captured
    once into a CUDA graph and replayed, which takes the host's launch
    cadence out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm-up outside the capture
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(fns))


# -- kernel inputs at the main path's shapes ----------------------------------

def attention_case(rng, dev, dtype, *, B, W, Hq, Hkv, n_pages=64, P=24):
    """q, pages, tables, lengths: ragged lengths crossing page edges, one dead
    slot (B > 1) whose table row is all trash page, trash-page entries past
    each live row's pages, and a trash page full of large values."""
    D = 128
    trash = n_pages
    q = torch.randn(B, W, Hq, D, device=dev).to(dtype)
    kp = torch.randn(n_pages + 1, PS, Hkv, D, device=dev)
    vp = torch.randn(n_pages + 1, PS, Hkv, D, device=dev)
    kp[trash], vp[trash] = 1e4, -1e4
    kp, vp = kp.to(dtype), vp.to(dtype)
    lens = rng.integers(1, P * PS - W + 2, size=B)
    edges = [PS, PS + 1, 2 * PS - 1, 3 * PS]
    for i in range(1, min(B, len(edges) + 1)):
        lens[i] = min(edges[i - 1], P * PS - W + 1)
    lens[0] = P * PS - W + 1
    tables = np.full((B, P), trash, np.int32)
    for b in range(B):
        used = -(-(int(lens[b]) + W - 1) // PS)
        tables[b, :used] = rng.permutation(n_pages)[:used]
    if B > 1:
        lens[-1] = 0
        tables[-1] = trash
    return (q, kp, vp, torch.tensor(tables, device=dev),
            torch.tensor(lens.astype(np.int32), device=dev))


def attention_cost(q, kp, tables, lengths):
    """(bytes, operations) one paged-attention call needs on these inputs:
    each query and output element once, the K and V rows of the keys each
    slot's deepest row reads, the table entries that name them."""
    B, W, Hq, D = q.shape
    Hkv = kp.shape[2]
    elt = q.element_size()
    lens = lengths.cpu().numpy().astype(np.int64)
    keys = np.minimum(np.where(lens > 0, lens + W - 1, 0),
                      tables.shape[1] * PS)
    nbytes = (2 * q.numel() * elt + int(keys.sum()) * Hkv * D * 2 * elt
              + int(np.ceil(keys / PS).sum()) * 4 + B * 4)
    rows_keys = sum(max(int(lens[b]) + w, 0) if lens[b] > 0 else 0
                    for b in range(B) for w in range(W)) * Hq
    return nbytes, 4 * D * rows_keys


def bound(nbytes: float, nops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(kernel, label, got, want, dtype) -> float:
    name = f"{kernel} {label}"
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[kernel][dtype]
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        raise AssertionError(f"{name}: kernel disagrees with plain version "
                             f"(max abs err {err}, tol {tol})")
    return err


# -- phases ---------------------------------------------------------------------

def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is visible")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return torch.cuda.get_device_name(0), smi.stdout.strip().splitlines()[0]


def phase_parity(dev) -> dict:
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    errs = {"rmsnorm": 0.0, "paged_attention_mq": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for d in (3584, 2048):
            scale = torch.randn(d, device=dev).to(dtype)
            for rows in (1, 4, 64, 4097):
                x = torch.randn(rows, d, device=dev).to(dtype)
                got = ops.rmsnorm(x, scale)
                torch.cuda.synchronize()
                errs["rmsnorm"] = max(errs["rmsnorm"], check(
                    "rmsnorm", f"rows={rows} d={d} {dtype}", got,
                    ref.rmsnorm(x, scale), dtype))
        for Hq, Hkv in ((28, 4), (16, 8)):
            for W in (1, 5, 64):
                for B in (1, 8):
                    q, kp, vp, tb, ln = attention_case(
                        rng, dev, dtype, B=B, W=W, Hq=Hq, Hkv=Hkv)
                    got = ops.paged_attention_mq(q, kp, vp, tb, ln)
                    torch.cuda.synchronize()
                    errs["paged_attention_mq"] = max(
                        errs["paged_attention_mq"],
                        check("paged_attention_mq",
                              f"Hq={Hq} Hkv={Hkv} W={W} B={B} {dtype}", got,
                              ref.paged_attention_mq(q, kp, vp, tb, ln),
                              dtype))
    tols = {k: {str(dt).split(".")[-1]: t for dt, t in v.items()}
            for k, v in TOL.items()}
    log(f"parity ok: 16 rmsnorm + 24 paged_attention_mq cases, tol "
        f"(rtol=atol) {tols}; max abs err {errs}")
    return errs


def phase_small(dev) -> None:
    model = build_model(smoke_config("qwen2-7b"))
    cpu_params = model.init(0, device="cpu")
    prompts = [[5, 17, 33, 2, 9], [100, 200, 300], [7] * 11, list(range(40))]

    def serve(device):
        params = tree_map(lambda t: t.to(device), cpu_params)
        eng = ServeEngine(model, params, max_slots=3, max_len=128,
                          page_size=PS, prefill_chunk=16, device=device)
        for p in prompts:
            eng.submit(p, max_new_tokens=8)
        return {r.rid: r.output for r in eng.run_until_drained()}

    want, got = serve("cpu"), serve(dev)
    if got != want:
        raise AssertionError(f"SMOKE engine on the card {got} != CPU {want}")
    log("small input: card streams == CPU streams (SMOKE qwen2-7b, float32)")


def phase_main():
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    eng = launch_serve.main(MAIN_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: (c.kernel, c.plain) for k, c in ops.COUNTS.items()}
    cfg = eng.model.cfg
    done = eng.finished
    if len(done) != 8 or any(r.error is not None for r in done):
        raise AssertionError(f"main path: {len(done)} finished, errors "
                             f"{[r.error for r in done if r.error]}")
    for r in done:
        if len(r.output) != 32 or not all(0 <= t < cfg.vocab for t in r.output):
            raise AssertionError(f"request {r.rid}: bad output {r.output}")
    for name, (kernel, plain) in counts.items():
        if kernel <= 0 or plain != 0:
            raise AssertionError(f"main path: {name} launched {kernel} times, "
                                 f"plain version ran {plain} times")
    if eng.stats["prefix_hits"] <= 0:
        raise AssertionError("main path: no prefix-cache hit")
    toks = sum(len(r.output) for r in done)
    s = eng.stats
    log(f"main path: qwen2-7b {cfg.n_layers} layers {cfg.dtype}, {len(done)} "
        f"requests, {toks} tokens, {toks / wall:.1f} tok/s wall "
        f"(init included: {wall:.2f}s), ticks={s['ticks']} "
        f"chunks={s['chunk_prefills']} pages_high_water="
        f"{s['pages_high_water']} prefix_hits={s['prefix_hits']} "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()} B; "
        f"launches {counts}")
    return {k: v[0] for k, v in counts.items()}, eng


def phase_timing(dev) -> dict:
    """Kernel, plain-version and yardstick times at the main path's decode
    shapes (4 slots, bf16, qwen2-7b): device time from CUDA-graph replay,
    with the host-issued (eager) time printed beside."""
    import torch.nn.functional as F
    cfg = get_config("qwen2-7b")
    dtype = torch.bfloat16
    rng = np.random.default_rng(1)
    out = {}

    def measure(name, fns, shape, nbytes, nops):
        b_ms, b_by = bound(nbytes, nops, dtype)
        t = {k: device_ms(v) for k, v in fns.items()}
        eager = {k: time_ms(v[0]) for k, v in fns.items()}
        out[name] = dict(ms=t["kernel"], plain_ms=t["plain"],
                         library_ms=t["library"], bound_ms=b_ms,
                         bound_by=b_by, shape=shape)
        log(f"timing {name} [{shape}]: device kernel {t['kernel']:.5f} ms, "
            f"plain {t['plain']:.5f} ms, library {t['library']:.5f} ms, "
            f"bound {b_ms:.6f} ms ({b_by}); host-issued kernel "
            f"{eager['kernel']:.5f} ms, plain {eager['plain']:.5f} ms, "
            f"library {eager['library']:.5f} ms")

    d, rows = cfg.d_model, 4
    xs = [torch.randn(rows, d, device=dev).to(dtype) for _ in range(8)]
    scale = torch.randn(d, device=dev).to(dtype)
    measure("rmsnorm", {
        "kernel": [lambda x=x: ops.rmsnorm(x, scale) for x in xs],
        "plain": [lambda x=x: ref.rmsnorm(x, scale) for x in xs],
        "library": [lambda x=x: F.rms_norm(x, (d,), scale, 1e-6)
                    for x in xs]},
        f"x ({rows}, {d}) bf16",
        2 * xs[0].numel() * xs[0].element_size() + d * 2, 4 * xs[0].numel())

    # one page pool per layer, as in a decode step: 28 layers' pages are
    # larger than the 50 MB L2, so each call finds its K/V in HBM
    B, W, Hq, Hkv, D = 4, 1, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n_pages, P = 128, 32
    lens = np.array([300, 288, 310, 276], np.int32)
    tables = np.stack([rng.permutation(n_pages)[:P] for _ in range(B)])
    tb = torch.tensor(tables.astype(np.int32), device=dev)
    ln = torch.tensor(lens, device=dev)
    q = torch.randn(B, W, Hq, D, device=dev).to(dtype)
    layers = [(torch.randn(n_pages + 1, PS, Hkv, D, device=dev).to(dtype),
               torch.randn(n_pages + 1, PS, Hkv, D, device=dev).to(dtype))
              for _ in range(cfg.n_layers)]
    mask = (torch.arange(P * PS, device=dev)[None, :]
            < ln[:, None])[:, None, None, :]                      # (B,1,1,S)

    def library(q, kp, vp, tb):
        b = tb.shape[0]
        k = kp[tb.long()].reshape(b, -1, Hkv, D).transpose(1, 2)
        v = vp[tb.long()].reshape(b, -1, Hkv, D).transpose(1, 2)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k, v, attn_mask=mask[:b], enable_gqa=True)

    nbytes, nops = attention_cost(q, layers[0][0], tb, ln)
    measure("paged_attention_mq", {
        "kernel": [lambda kv=kv: ops.paged_attention_mq(q, *kv, tb, ln)
                   for kv in layers],
        "plain": [lambda kv=kv: ref.paged_attention_mq(q, *kv, tb, ln)
                  for kv in layers],
        "library": [lambda kv=kv: library(q, *kv, tb) for kv in layers]},
        f"decode B={B} W={W} Hq={Hq} Hkv={Hkv} D={D} ps={PS} "
        f"lengths={lens.tolist()} bf16", nbytes, nops)

    # the prefill-chunk shapes (one window of 64 at position 192), printed
    W2, start = 64, 192
    q2 = torch.randn(1, W2, Hq, D, device=dev).to(dtype)
    ln2 = torch.tensor([start + 1], dtype=torch.int32, device=dev)
    tb2 = tb[:1]
    b2, by2 = bound(*attention_cost(q2, layers[0][0], tb2, ln2), dtype)
    x2 = torch.randn(64, d, device=dev).to(dtype)
    t_pa = device_ms([lambda kv=kv: ops.paged_attention_mq(q2, *kv, tb2, ln2)
                      for kv in layers])
    p_pa = device_ms([lambda kv=kv: ref.paged_attention_mq(q2, *kv, tb2, ln2)
                      for kv in layers])
    log(f"prefill-chunk shapes (device): paged_attention_mq W={W2} "
        f"start={start}: {t_pa:.5f} ms (plain {p_pa:.5f} ms, bound "
        f"{b2:.6f} ms by {by2}); rmsnorm (64, {d}): "
        f"{device_ms([lambda: ops.rmsnorm(x2, scale)]):.5f} ms (plain "
        f"{device_ms([lambda: ref.rmsnorm(x2, scale)]):.5f} ms)")
    return out


def phase_step(eng, times) -> None:
    """One decode step and one prefill chunk of the main path's model, timed
    as the host issues them and as a replayed CUDA graph (device time), with
    the two kernels' share of the device time."""
    model, params, storage = eng.model, eng.params, eng.pool.storage
    cfg, dev = model.cfg, eng.device
    rng = np.random.default_rng(2)
    B, P = eng.max_slots, eng.sched.pages_per_slot
    lens = torch.tensor([300, 288, 310, 276][:B], dtype=torch.int32,
                        device=dev)
    tables = torch.tensor(
        np.stack([rng.permutation(eng.pool.num_pages)[:P] for _ in range(B)]
                 ).astype(np.int32), device=dev)
    toks = torch.tensor(rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32),
                        device=dev)
    wp = tables[torch.arange(B, device=dev), (lens // PS).long()]
    wo = lens % PS

    def decode():
        return model.paged_decode_step(params, storage, tables, lens, toks,
                                       wp, wo)

    start, C = 192, 64
    row = tables[0]
    pages = row[start // PS:(start + C) // PS]
    chunk = torch.tensor(rng.integers(0, cfg.vocab, (1, C)).astype(np.int32),
                         device=dev)

    def prefill():
        return model.paged_prefill_chunk(params, storage, row, pages, start,
                                         chunk)

    kernels = (cfg.n_layers * times["paged_attention_mq"]["ms"]
               + (2 * cfg.n_layers + 1) * times["rmsnorm"]["ms"])
    for name, fn in (("decode step (4 slots)", decode),
                     ("prefill chunk (64 at 192)", prefill)):
        host = time_ms(fn, iters=10, warmup=2)
        devt = device_ms([fn], reps=10)
        log(f"{name}: host-issued {host:.3f} ms, device {devt:.3f} ms "
            f"(card idle {max(0.0, 1 - devt / host):.1%} of the host-issued "
            f"time)")
    log(f"decode step: {cfg.n_layers} paged_attention_mq + "
        f"{2 * cfg.n_layers + 1} rmsnorm launches at their device times = "
        f"{kernels:.3f} ms")


SOURCES = {
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:38"),
    "paged_attention_mq": ("src/repro_torch/csrc/paged_attention.cu",
                           "src/repro/kernels/paged_attention.py:171"),
}


def main() -> int:
    kind, smi = phase_device()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.library()
    log(f"build: kernels ready in {time.perf_counter() - t0:.1f}s "
        f"({', '.join(p.name for p in build.sources())})")
    errs = phase_parity(dev)
    phase_small(dev)
    launches, eng = phase_main()
    times = phase_timing(dev)
    phase_step(eng, times)
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "parity": "pass",
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "timed_shape": t["shape"]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
