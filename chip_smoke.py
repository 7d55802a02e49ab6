"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):

1. device      — a CUDA card must be visible; prints its name and power
                 limit.
2. build       — compiles the CUDA kernels from ``src/repro_torch/csrc``
                 (one nvcc per source, all at once) and prints what ptxas
                 reports of the flash-attention kernels' (both routes), the
                 D 97-128 paged-attention split kernels' and the combine
                 kernels', the K-64 wkv kernels' (both routes: the
                 CUDA-core time loop, and the tensor-core route's chunk
                 states, chunk-state pass and outputs) and the N = P = 64
                 SSD kernels' (the CUDA-core loop, and the tensor-core
                 route's segment states and outputs) registers, spills and
                 shared memory, with the tensor-core routes' dynamic shared
                 memory.
3. parity      — each kernel against its plain PyTorch version at the main
                 paths' shapes, with the tolerances printed beside them;
                 RMSNorm's three variants (the norm, the residual add fused
                 into it, Mamba-2's SiLU gate fused into it) at every row
                 count the main runs launch (1 to 4097 rows, main-spec's
                 verify forwards' 12 and 20 and its drafter's 512; d 3584,
                 7168, 2048 and an odd 1001), the fused add's sum bit for
                 bit;
                 flash attention on its tensor-core route (bf16, D 64 and
                 128: S 1024, 2048, a ragged 1000, a window, Sq != Sk,
                 strided q/k/v) and its CUDA-core route; paged attention
                 split over many key ranges (tables of 128 and 512 pages,
                 lengths on and beside a split edge, W 64 deep in the
                 table), float and int8 pages; paged attention at the
                 verify windows of main-spec (B 4, W 3 and 5, a 32-page
                 table), float and int8 pages, each call counted as a
                 verify call of its width; the wkv kernel on both
                 routes (the tensor-core route for K = V = 64 from one
                 chunk of 64 steps on: the full-width prefill, S 64 and 65,
                 each such call checked by its sub-count; S 63 and the
                 decode shape on CUDA cores), also with exact zeros and
                 denormals planted in w.
4. small       — the SMOKE qwen2-7b engine (float32) on the card emits the
                 same greedy streams as on the CPU, paged and then dense.
5. main        — full-width, full-depth qwen2-7b (28 layers, bf16, seeded
                 random weights) through the serving launcher, paged: 8
                 requests sharing a 256-token prefix, 32 new tokens each;
                 every request must finish, the paged path's kernels must
                 launch, every paged-attention call split over more than
                 one key range, no plain version may run, the prefix
                 cache must hit, and RMSNorm must launch once alone and
                 2 x 28 times with the residual add a step or chunk.
6. timing      — each kernel, its plain version and one PyTorch yardstick
                 call timed at the main paths' shapes (B1 also at
                 main-spec's verify window, B 4, W 5; device time from a
                 replayed CUDA graph; the host-issued time printed beside),
                 beside the bytes/operations bound; RMSNorm's variants at
                 every (rows, d) the main runs launch them with, beside the
                 ops they replace and a launch floor (a 1-element op); the
                 final norm's fused add, which stores no sum, apart.  The int8 paged
                 attention's yardstick is a composite (gather, dequant
                 multiply, ``scaled_dot_product_attention``): no one
                 PyTorch call takes int8 pages.
7. step        — one paged decode step and one prefill chunk, host-issued
                 and as device time, with RMSNorm's share.
8. main-int8   — the main run with ``--kv-quant int8``: every request must
                 finish, the int8 paged attention must launch (the float
                 one and every plain version not at all), the prefix cache
                 must hit, KV bytes a token must be 29568, and one prompt's
                 dequantized layer-0 K and V must lie within half a
                 quantization step of the bf16 run's (layer 0's inputs are
                 the same on both).  Prints the greedy streams' agreement
                 with the bf16 run, the peak device memory, ticks and the
                 pages' high water.  Then its decode step and prefill chunk
                 timed as in 7.
9. main-int8w  — the same with ``--weight-quant int8`` as well: every
                 request must finish and the peak device memory (the
                 weights quantized as they are drawn) must stay below the
                 bf16 run's.  Then its decode step and prefill chunk.
10. main-dense — the same model through the launcher's ``--dense`` path:
                 8 requests of 964-1007 tokens (a 960-token shared prefix),
                 so every whole-prompt prefill runs at bucket 1024, farmed
                 over the prefill farm; every request must finish,
                 flash attention must launch 28 times a prefill, every
                 launch on the tensor-core route, RMSNorm must launch once
                 alone and 2 x 28 times with the residual add a prefill or
                 decode step, and no plain version may run.  Then, in
                 float32 on the same weights, one prompt's prefill through
                 the kernel and through its plain version must give the
                 same layer-1 K cache (the gap of every layer printed).
                 Prints the peak device memory, how far the dense greedy
                 streams agree with the paged engine's on the same prompts,
                 and the wall time and mean TTFT of the same requests with
                 1 and 4 prefill-farm workers.
11. step-dense — one dense decode step (4 slots, max_len 2048) and one
                 bucket-1024 prefill, host-issued and as device time.
12. small-rwkv — the SMOKE rwkv6-3b engine (float32) on the card emits the
                 same greedy streams as on the CPU.
13. main-rwkv  — full-width, full-depth rwkv6-3b (32 layers, bf16, seeded
                 random weights, the float32 leaves in float32) through
                 the launcher, which picks the dense path by itself: 8
                 requests of 964-1007 tokens (bucket 1024), 32 new tokens
                 each; every request must finish with 32 in-vocab tokens,
                 the wkv kernel must launch exactly 32 times a prefill or
                 decode step, every prefill call on the tensor-core route
                 and every decode call on the CUDA-core one (by the
                 ``rwkv6_scan_tc`` sub-count), and no other kernel and no
                 plain version may run.  Then, in float32 on the same
                 weights, one prompt's prefill through the kernel and
                 through its plain version: layer 0's final wkv state is
                 gated (every layer's gap printed).  Prints the peak
                 device memory, wall tok/s and mean TTFT.
14. step-rwkv  — one 4-slot rwkv decode step and one bucket-1024 prefill,
                 host-issued and as device time, with the card's idle
                 share; the wkv kernel timed at the prefill and decode
                 shapes (kernel, plain, bound, and a composite yardstick:
                 the reference's chunked matmul form written in torch); the
                 prefill's bound at the TF32 tensor-core peak (its route),
                 the float32 CUDA-core one beside it.
15. parity-ssd — the SSD kernel against its plain version: the
                 reference's three cases, a ragged length, zamba2-7b's
                 prefill and decode shapes, S 63, 64 and 65 at N = P = 64,
                 a slow decay that carries the state across the
                 tensor-core route's segments, and every (N, P) it is
                 built for, B/C in bf16 and float32, from a state written
                 in place, from a given state and from zeros; every call
                 that the tensor-core route takes (N = P = 64, bf16 B/C,
                 S >= 64) checked by its sub-count.
16. small-zamba — the SMOKE zamba2-7b (float32) as aligned batches
                 (prefill, then decode steps at one position) on the card
                 emits the same greedy streams as on the CPU.
17. main-zamba — full-width, full-depth zamba2-7b (81 Mamba-2 layers and
                 3 applications of the shared block, bf16, seeded random
                 weights, the float32 leaves in float32) through
                 ``HybridLM``: 4 prompts of 1000 tokens, max_len 1032,
                 greedy to 32 new tokens; every row must get 32 in-vocab
                 tokens, the SSD kernel must launch exactly 81 times a
                 prefill or decode step, the 81 prefill calls on the
                 tensor-core route and every decode call on the CUDA-core
                 one (by the ``ssd_scan_tc`` sub-count), RMSNorm exactly 1
                 time alone, 87 times with the residual add and 81 times
                 with the SiLU gate a step, and no other kernel and no
                 plain version may run.  Then a second prefill compares every layer's SSD
                 call with the plain version on the same inputs: layer 0
                 is gated (every layer's gap printed).  Prints the
                 weights' bytes, the peak device memory, the prefill's
                 time and decode tok/s.
18. step-zamba — one 4-row decode step and one 4 x 1000 prefill,
                 host-issued and as device time, with the card's idle
                 share and RMSNorm's; the SSD kernel timed at the prefill and decode
                 shapes (kernel, plain, bound, and a composite yardstick:
                 the reference's chunked form ``_ssd_chunked`` in torch);
                 the prefill's bound at the TF32 tensor-core peak, the
                 float32 CUDA-core one beside it.

19. main-spec  — the main run with the self-2 drafter (``--spec-decode
                 self-2 --spec-k 4``): every request finishes, drafts are
                 proposed, the drafter's flash attention runs on the
                 tensor cores (2 launches a drafted token), the engine's
                 verify ticks are of widths 3 and 5 only (B1's verify
                 calls by width: the layers times the engine's
                 ``verify_widths``), B1 and B2 launch exactly as the ticks,
                 chunks and drafter forwards need; prints proposed,
                 accepted, the acceptance rate, verify ticks and wall
                 tok/s, and (not gated: the random full-depth model is
                 chaotic) each stream's first divergence from main's and a
                 verify window's position 0 against a decode step.  Then a
                 verify tick's parts timed (the verify forward at W 3 and
                 5, one drafter forward), and the gates on the same
                 weights cut to their first 2 layers: the self-1 and
                 self-2 drafters' streams equal to spec-off's (a
                 divergence fails, printed with the spec-off top-2 margin
                 there; the smallest margin of the spec-off run printed),
                 a verify window's position 0 within the stated limit of
                 a decode step, with the K/V each call wrote for position
                 0 compared, and a window off by one position shown to
                 exceed that limit.
20. main-spec-int8 — the same with ``--kv-quant int8`` (B1-int8 on verify
                 windows), against main-int8.
21. main-sampled — main's 8 requests seeded, with top-k (k 40, T 0.8),
                 top-p (0.9, T 0.8) and temperature (T 0.8) heads cycled,
                 served twice, then through rejection-sampled speculation
                 (self-2, ``spec_temperature`` 0.8), twice: each pair's
                 streams identical.  ``prng.bits`` on the card equals the
                 CPU's bit for bit; a temperature histogram over 8 logits
                 within the chi-square bound of softmax; the host-issued
                 time of one seeded draw over the full vocab.
22. traffic    — the launcher's ``--traffic poisson --clock wall``: 16
                 arrivals at 2 requests a second; prints the report (TTFT,
                 ITL and e2e percentiles, tok/s, goodput), which must be
                 complete; the paged kernels launch, no plain version runs.

zamba2 has no serving-engine mode, as in the reference: phases 16-18 call
the model's API (``prefill``, ``lm_head``, ``decode_step``) directly.

The line before the last is the ``{"kernels": [...]}`` record; the last is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import functools
import gc
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
from repro_torch.models.module import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve import prng  # noqa: E402
from repro_torch.serve import quant as QZ  # noqa: E402
from repro_torch.serve import sampling as SM  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
# dense peaks: bf16 and TF32 on the tensor cores, float32 on CUDA cores
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, "tf32": 494.7e12,
                  torch.float32: 67e12}
# rtol = atol per kernel and dtype.  bf16 rmsnorm outputs are O(1), where
# one bf16 ulp is 2**-7 ~ 8e-3; bf16 paged-attention outputs are ~0.1; the
# bf16 attention limits of flash attention and the int8 paged attention sit
# near twice the largest error seen on the card (0.00195 for both, one bf16
# ulp in [0.25, 0.5)).  float32 differs by summation order only.
TOL = {"rmsnorm": {torch.float32: 2e-4, torch.bfloat16: 2e-2},
       "paged_attention_mq": {torch.float32: 2e-4, torch.bfloat16: 1e-2},
       "paged_attention_mq_int8": {torch.float32: 2e-4, torch.bfloat16: 4e-3},
       "flash_attention": {torch.float32: 2e-4, torch.bfloat16: 4e-3}}
# main-dense, float32: the layer-1 K cache of a prefill through the flash
# kernel against one through its plain version, max |dK| over max |K|
# (layer 0's K precedes any attention)
K_GAP_TOL = 1e-3
# the wkv kernel against its plain version: both compute in float32 from
# the same inputs (bf16 r, k, v widened exactly) and differ in summation
# order only; max |d| over max(1, max |plain|).  main-rwkv's layer-0 wkv
# state is the same function at the parity phase's full-width prefill
# shape, so it is gated at the same limit.
RWKV_REL = 1e-5
# (B, S, H, K, V): the reference's three cases (K != V in the third), a
# ragged length, rwkv6-3b's full-width prefill and decode shapes, and one
# step short of the tensor-core route's chunk (64), on it and past it
RWKV_CASES = [(2, 128, 3, 16, 16), (1, 64, 2, 8, 8), (1, 192, 1, 32, 16),
              (2, 200, 3, 64, 64), (1, 1024, 40, 64, 64), (4, 1, 40, 64, 64),
              (2, 63, 3, 64, 64), (2, 64, 3, 64, 64), (2, 65, 3, 64, 64)]
# ... and with exact zeros and as many denormals planted in w (B, S, H, K,
# V, planted): the full-width decay range has both
RWKV_PLANTED = [(1, 1024, 40, 64, 64, 200), (2, 65, 3, 64, 64, 8),
                (2, 63, 3, 64, 64, 8)]
# the SSD kernel against its plain version: both in float32 from the same
# inputs (bf16 B and C widened exactly); the kernel's chunked form
# reassociates the decay products (exp of a cumsum for a product of exps)
# and the sums, so they differ by rounding only (a CPU mirror of the
# kernel's arithmetic gave 8.7e-7 at zamba2's shapes); max |d| over
# max(1, max |plain|), as for RWKV_REL.  main-zamba's layer-0 SSD call is
# the same function at the parity phase's prefill shape: the same limit,
# on max |d| / max |plain| (its values are far below 1 at random init).
SSD_REL = 1e-5
# (B, S, H, P, N): the reference's three cases, a ragged length,
# zamba2-7b's full-width prefill and decode shapes, and one step short of
# the tensor-core route's chunk (64), on it and past it
SSD_CASES = [(2, 256, 3, 16, 8), (1, 128, 2, 32, 16), (1, 512, 1, 8, 4),
             (2, 200, 3, 16, 8), (4, 1000, 112, 64, 64), (4, 1, 112, 64, 64),
             (2, 63, 8, 64, 64), (2, 64, 8, 64, 64), (2, 65, 8, 64, 64)]
# (B, S, H): a decay 200 times slower than zamba2's init (la = -0.005 dt)
# keeps the state alive across the tensor-core route's segments of 256
# steps, which at the init's decay carry about e^-200 of it
SSD_SLOW_CASES = [(2, 1000, 5), (1, 300, 3)]
ZAMBA_ROWS, ZAMBA_PROMPT, ZAMBA_NEW = 4, 1000, 32    # main-zamba's batch
ZAMBA_MAX_LEN = 1032
RWKV_ARGS = ["--arch", "rwkv6-3b", "--requests", "8", "--max-new", "32",
             "--slots", "4", "--max-len", "2048", "--shared-prefix", "960",
             "--device", "cuda"]
FARM_WORKERS = (1, 4, 1, 4)        # main-dense's farm sizes, alternated
PS = 16                            # the main path's page size
# main-spec: the self-drafter of the target's first 2 layers, up to 4
# drafts a slot (verify windows of 3 or 5)
SPEC_ARGS = ["--spec-decode", "self-2", "--spec-k", "4"]
VERIFY_WIDTHS = (3, 5)
# The gates of speculation hold the full-width weights cut to their first
# GATE_DEPTH layers: the random full-depth model is chaotic (main-dense's
# float32 K gap grows from 3e-7 at layer 1 to 1.0 by layer 16), so a verify
# window's position 0 and a decode step of the same token, whose GEMMs have
# other row counts, part by O(1) logits at depth 28 (main-spec prints 6-8
# max |d logit|, bf16).  At full depth both are printed, not gated.  The
# stream gate: at depth 2 every spec-on stream equals its spec-off twin.
# The per-call gate: that gap at depth 2 over the true vocab (logits ~1.2
# rms at random init), bf16, below VERIFY_LOGIT_TOL by KV policy; the
# readings it was set from are in PERF.md §6: W 3 0.0088 with bf16
# pages, 0.1197 with int8 pages (the calls' layer-1 K/V of position 0
# land a code step apart; printed), W 5 0.0 with both; a window off by one
# position (5.8-7.1) must exceed the limit.
GATE_DEPTH = 2
VERIFY_LOGIT_TOL = {"off": 0.05, "int8": 0.25}
# main-sampled: the heads (k 40, T 0.8; p 0.9, T 0.8; T 0.8) cycled over
# main's 8 requests, each seeded; the histogram's logit row and draws; its
# bound: the chi-square of 7 degrees of freedom at p = 0.001
SAMPLE_T = 0.8
HIST_LOGITS = (2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, 0.2)
HIST_DRAWS = 100_000
CHI2_BOUND = 24.32
# traffic: 16 Poisson arrivals at 2 requests a second (main serves its 8
# requests closed-loop at several a second; printed beside it)
TRAFFIC_ARGS = ["--requests", "16", "--traffic", "poisson", "--clock",
                "wall", "--rate", "2.0"]
MAIN_ARGS = ["--arch", "qwen2-7b", "--requests", "8", "--max-new", "32",
             "--slots", "4", "--max-len", "512", "--page-size", str(PS),
             "--prefill-chunk", "64", "--prefix-cache", "on",
             "--shared-prefix", "256", "--device", "cuda"]
# the paged path runs (with the sub-counts of fused add + norm calls and of
# split paged-attention calls)
PAGED_KERNELS = ("rmsnorm", "rmsnorm_add", "paged_attention_mq",
                 "paged_attention_mq_split")
INT8_KERNELS = ("rmsnorm", "rmsnorm_add",               # ... with int8 pages
                "paged_attention_mq_int8", "paged_attention_mq_split")
# ... with speculation: verify windows, and the drafter's flash attention
SPEC_KERNELS = ("flash_attention", "flash_attention_tc")
# B2's parity cases: every row count the main runs launch it with (decode 4,
# prefill chunk 64, dense prefill 1024, zamba2 prefill 4000, main-spec's
# verify forwards over 4 slots at W 3 and 5, 12 and 20, and its drafter's
# forward over a bucket of 512), one row, a ragged 1000 and 4097; d of
# qwen2-7b and zamba2-7b (3584), zamba2's d_inner (7168, the gated norm's),
# 2048, and one off the kernel's 16-byte vector (its scalar route)
NORM_ROWS = (1, 4, 12, 20, 64, 512, 1000, 1024, 4000, 4097)
NORM_DIMS = (3584, 7168, 2048, 1001)
# (rows, d) of each B2 variant in the main runs: decode, prefill chunk,
# dense prefill, zamba2 prefill (the first norm, each Mamba layer's and the
# shared block's at d 3584, the gated norm at d_inner 7168), main-spec's
# verify forwards (12 and 20 rows) and drafter forward (512); final_rmsnorm
# is the fused add of a model's last norm, which stores no sum
_QWEN_NORM_ROWS = [(4, 3584), (64, 3584), (1024, 3584), (4000, 3584),
                   (12, 3584), (20, 3584), (512, 3584)]
NORM_TIMED = {"rmsnorm": _QWEN_NORM_ROWS, "add_rmsnorm": _QWEN_NORM_ROWS,
              "final_rmsnorm": _QWEN_NORM_ROWS,
              "gated_rmsnorm": [(4, 7168), (4000, 7168)]}
INT8_KV_BYTES = 29568              # qwen2-7b: 28 x 2 x 4 x (128 + 4) bytes
# (Hq, Hkv, D) of the int8 kernel's parity cases: qwen2-7b and SMOKE
INT8_HEADS = ((28, 4, 128), (4, 2, 16))
DENSE_ARGS = ["--arch", "qwen2-7b", "--dense", "--requests", "8",
              "--max-new", "32", "--slots", "4", "--max-len", "2048",
              "--shared-prefix", "960", "--device", "cuda"]
# (B, Sq, Sk, Hq, Hkv, D, causal, window): the reference's five kernel
# cases, a ragged length, D = 64 and 256, the dense prefill's shapes (S
# 1024 and 2048) and a ragged 1000 at its heads, Sq != Sk both ways, the
# self-drafter's buckets; bf16
# at D 64 and 128 takes the tensor-core route
FLASH_CASES = [(2, 256, 256, 4, 2, 32, True, None),
               (1, 512, 512, 2, 2, 16, True, 100),
               (2, 256, 256, 4, 1, 32, False, None),
               (1, 128, 128, 8, 8, 64, True, None),
               (1, 384, 384, 2, 1, 32, True, 64),
               (1, 200, 200, 4, 2, 128, True, None),
               (1, 200, 200, 8, 2, 64, True, 48),
               (1, 300, 300, 8, 2, 256, True, None),
               (1, 1024, 1024, 28, 4, 128, True, None),
               (1, 2048, 2048, 28, 4, 128, True, None),
               (1, 1000, 1000, 28, 4, 128, True, None),
               (1, 130, 90, 4, 2, 64, False, None),
               (2, 300, 200, 28, 4, 128, True, None),
               # the self-2 drafter's buckets in main-spec (512) and the
               # smallest one (16)
               (1, 512, 512, 28, 4, 128, True, None),
               (1, 16, 16, 28, 4, 128, True, None)]
# (B, W, Hq, Hkv, P, n_pages, lengths): paged attention split over many key
# ranges (64 positions each): tables of 128 and 512 pages of 16 (32 and
# 128 splits), lengths on a split edge (64, 128: the last key ends a range)
# and beside it (63, 65, 129), a dead slot, W 64 deep in the table
SPLIT_CASES = [(4, 1, 28, 4, 128, 160, (2000, 64, 65, 0)),
               (4, 1, 28, 4, 512, 600, (8000, 63, 128, 129)),
               (2, 4, 28, 4, 128, 300, (1500, 0)),
               (1, 64, 28, 4, 128, 160, (1900,)),
               (1, 64, 16, 8, 512, 600, (6000,))]


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

def attention_case(rng, dev, dtype, *, B, W, Hq, Hkv, D=128, n_pages=64,
                   P=24):
    """q, pages, tables, lengths: ragged lengths crossing page edges, one dead
    slot (B > 1) whose table row is all trash page, trash-page entries past
    each live row's pages, and a trash page full of large values."""
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


def quantize_pages(kp, vp):
    """(k codes, v codes, k scales, v scales) of float pages, per (row,
    head), as the int8 pool stores them."""
    (kq, ks), (vq, vs) = (QZ.Int8KVQuant().quantize(t) for t in (kp, vp))
    return kq, vq, ks, vs


def attention_cost(q, kp, tables, lengths, scaled=False):
    """(bytes, operations) one paged-attention call needs on these inputs:
    each query and output element once, the K and V rows of the keys each
    slot's deepest row reads (with their 4-byte scales a row and head for
    int8 pages), the table entries that name them."""
    B, W, Hq, D = q.shape
    Hkv = kp.shape[2]
    elt = q.element_size()
    lens = lengths.cpu().numpy().astype(np.int64)
    keys = np.minimum(np.where(lens > 0, lens + W - 1, 0),
                      tables.shape[1] * PS)
    row = D * kp.element_size() + (4 if scaled else 0)
    nbytes = (2 * q.numel() * elt + int(keys.sum()) * Hkv * 2 * row
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


def phase_parity_rmsnorm(dev) -> dict:
    """B2's three variants against their plain versions at NORM_ROWS x
    NORM_DIMS, bf16 and float32 (the gated norm: y float32, z and scale in
    the dtype): the norm within TOL["rmsnorm"], the fused add's sum s bit
    for bit, and its norm without the sum (``keep_sum=False``) bit for bit
    the one beside it.  Max abs error by variant."""
    errs = {"rmsnorm": 0.0, "add_rmsnorm": 0.0, "gated_rmsnorm": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for d in NORM_DIMS:
            scale = torch.randn(d, device=dev).to(dtype)
            for rows in NORM_ROWS:
                x, dl = (torch.randn(rows, d, device=dev).to(dtype)
                         for _ in range(2))
                y = torch.randn(rows, d, device=dev)
                label = f"rows={rows} d={d} {dtype}"
                got = {"rmsnorm": ops.rmsnorm(x, scale),
                       "add_rmsnorm": ops.add_rmsnorm(x, dl, scale),
                       "gated_rmsnorm": ops.gated_rmsnorm(y, 2 * x, scale)}
                nosum = ops.add_rmsnorm(x, dl, scale, keep_sum=False)
                torch.cuda.synchronize()
                if nosum[0] is not None or not torch.equal(
                        nosum[1], got["add_rmsnorm"][1]):
                    raise AssertionError(f"add_rmsnorm {label}: the norm "
                                         "without the sum differs")
                want = {"rmsnorm": ref.rmsnorm(x, scale),
                        "add_rmsnorm": ref.add_rmsnorm(x, dl, scale),
                        "gated_rmsnorm": ref.gated_rmsnorm(y, 2 * x, scale)}
                if not torch.equal(got["add_rmsnorm"][0],
                                   want["add_rmsnorm"][0]):
                    raise AssertionError(f"add_rmsnorm {label}: s is not "
                                         "x + delta bit for bit")
                for name in errs:
                    g, w = got[name], want[name]
                    if name == "add_rmsnorm":
                        g, w = g[1], w[1]
                    errs[name] = max(errs[name], check(
                        "rmsnorm", f"{name} {label}", g, w, dtype))
    return errs


def phase_parity(dev) -> dict:
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    norm_errs = phase_parity_rmsnorm(dev)
    errs = {"rmsnorm": max(norm_errs.values()), "paged_attention_mq": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for Hq, Hkv in ((28, 4), (16, 8)):
            for W in (1, 3, 5, 64):
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
    flash_errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for B, Sq, Sk, Hq, Hkv, D, causal, window in FLASH_CASES:
            q = torch.randn(B, Sq, Hq, D, device=dev).to(dtype)
            k = torch.randn(B, Sk, Hkv, D, device=dev).to(dtype)
            v = torch.randn(B, Sk, Hkv, D, device=dev).to(dtype)
            got = ops.flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            err = check("flash_attention",
                        f"B={B} S={Sq}/{Sk} Hq={Hq} Hkv={Hkv} D={D} "
                        f"causal={causal} window={window} {dtype}", got,
                        ref.flash_attention(q, k, v, causal=causal,
                                            window=window), dtype)
            key = str(dtype).split(".")[-1]
            flash_errs[key] = max(flash_errs.get(key, 0.0), err)
    # q, k, v sliced out of one fused buffer: read through their strides
    qkv = torch.randn(2, 1024, 36, 128, device=dev).to(torch.bfloat16)
    q, k, v = qkv[:, :, :28], qkv[:, :, 28:32], qkv[:, :, 32:]
    ops.reset_counts()
    got = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    if ops.COUNTS["flash_attention_tc"].kernel != 1:
        raise AssertionError("flash_attention strided bf16 D 128: not on the "
                             "tensor-core route")
    flash_errs["bfloat16"] = max(flash_errs["bfloat16"], check(
        "flash_attention", "strided q/k/v B=2 S=1024 Hq=28 Hkv=4 D=128 "
        "bfloat16", got, ref.flash_attention(q, k, v), torch.bfloat16))
    errs["flash_attention"] = max(flash_errs.values())
    int8_errs = phase_parity_int8(rng, dev)
    errs["paged_attention_mq_int8"] = max(int8_errs.values())
    split_errs = phase_parity_split(rng, dev)
    errs["paged_attention_mq"] = max(errs["paged_attention_mq"],
                                     split_errs["paged_attention_mq"])
    errs["paged_attention_mq_int8"] = max(
        errs["paged_attention_mq_int8"], split_errs["paged_attention_mq_int8"])
    verify_errs = phase_parity_verify(rng, dev)
    for name in verify_errs:
        errs[name] = max(errs[name], verify_errs[name])
    tols = {k: {str(dt).split(".")[-1]: t for dt, t in v.items()}
            for k, v in TOL.items()}
    log(f"parity ok: {6 * len(NORM_ROWS) * len(NORM_DIMS)} rmsnorm (3 "
        f"variants; the fused add's s bit for bit) + 32 paged_attention_mq + "
        f"{2 * len(FLASH_CASES) + 1} flash_attention + 24 "
        f"paged_attention_mq_int8 cases + {4 * len(SPLIT_CASES)} split "
        f"paged-attention cases, tol (rtol=atol) {tols}; max abs err "
        f"{errs}; rmsnorm by variant {norm_errs}; flash_attention by dtype "
        f"{flash_errs}; "
        f"paged_attention_mq_int8 by dtype {int8_errs}; split cases "
        f"{split_errs}; verify windows (B 4, W {VERIFY_WIDTHS}, a 32-page "
        f"table, 4 cases a page kind) {verify_errs}")
    return errs


def phase_parity_verify(rng, dev) -> dict:
    """Paged attention at main-spec's verify windows: B 4, W 3 and 5 (W·G
    = 21 and 35 query rows a KV head, the last 16-row tile partial), 28/4
    heads of 128, a 32-page table over 128 pages, float and int8 pages, q
    bf16 and f32, a dead slot; each call one kernel launch.  Max abs error
    by kernel name."""
    errs = {"paged_attention_mq": 0.0, "paged_attention_mq_int8": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for W in VERIFY_WIDTHS:
            q, kp, vp, tb, ln = attention_case(rng, dev, dtype, B=4, W=W,
                                               Hq=28, Hkv=4, n_pages=128,
                                               P=32)
            pages = quantize_pages(kp.float(), vp.float())
            for name, args in (
                    ("paged_attention_mq", (kp, vp, tb, ln)),
                    ("paged_attention_mq_int8", (pages[0], pages[1], tb, ln,
                                                 *pages[2:]))):
                ops.reset_counts()
                got = ops.paged_attention_mq(q, *args)
                torch.cuda.synchronize()
                if ops.COUNTS[name] != ops.LaunchCount(kernel=1):
                    raise AssertionError(f"{name} W={W}: not one kernel "
                                         f"launch ({ops.COUNTS[name]})")
                if got[-1, 0].any():
                    raise AssertionError(f"{name} W={W}: dead slot not zero")
                errs[name] = max(errs[name], check(
                    name, f"verify B=4 W={W} P=32 {dtype}", got,
                    ref.paged_attention_mq(q, *args), dtype))
    return errs


def phase_parity_split(rng, dev) -> dict:
    """Paged attention over SPLIT_CASES (many key splits), float and int8
    pages, q in bf16 and f32: the split and combine kernels against the
    plain version; a dead slot's row 0 must be zero.  Max abs error by
    kernel name."""
    from repro_torch.kernels.paged_attention import split_count
    errs = {"paged_attention_mq": 0.0, "paged_attention_mq_int8": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for B, W, Hq, Hkv, P, n_pages, lengths in SPLIT_CASES:
            trash = n_pages
            q = torch.randn(B, W, Hq, 128, device=dev).to(dtype)
            kp = torch.randn(n_pages + 1, PS, Hkv, 128, device=dev)
            vp = torch.randn(n_pages + 1, PS, Hkv, 128, device=dev)
            kp[trash], vp[trash] = 1e4, -1e4
            tables = np.full((B, P), trash, np.int32)
            for b, n in enumerate(lengths):
                used = -(-(n + W - 1) // PS) if n else 0
                tables[b, :used] = rng.permutation(n_pages)[:used]
            tb = torch.tensor(tables, device=dev)
            ln = torch.tensor(np.asarray(lengths, np.int32), device=dev)
            label = (f"split B={B} W={W} Hq={Hq} Hkv={Hkv} P={P} "
                     f"({split_count(P, PS)} splits) lengths={lengths} "
                     f"{dtype}")
            pages = quantize_pages(kp, vp)
            for name, args in (
                    ("paged_attention_mq", (kp.to(dtype), vp.to(dtype), tb,
                                            ln)),
                    ("paged_attention_mq_int8", (pages[0], pages[1], tb, ln,
                                                 *pages[2:]))):
                got = ops.paged_attention_mq(q, *args)
                torch.cuda.synchronize()
                if 0 in lengths and got[list(lengths).index(0), 0].any():
                    raise AssertionError(f"{name} {label}: dead slot not zero")
                errs[name] = max(errs[name], check(
                    name, label, got, ref.paged_attention_mq(q, *args),
                    dtype))
    return errs


def phase_parity_int8(rng, dev) -> dict:
    """The int8 paged attention against its plain version: decode (W 1), a
    verify width (W 4) and a prefill chunk (W 64), qwen2-7b's and SMOKE's
    heads, q in bf16 and f32, pages quantized per (row, head) from the
    float case (its trash page of large values included), ragged lengths
    and a dead slot whose window position 0 (length 0) must be zero.  Max abs error by q dtype."""
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for Hq, Hkv, D in INT8_HEADS:
            for W in (1, 4, 64):
                for B in (1, 4):
                    q, kp, vp, tb, ln = attention_case(
                        rng, dev, dtype, B=B, W=W, Hq=Hq, Hkv=Hkv, D=D)
                    pages = quantize_pages(kp.float(), vp.float())
                    got = ops.paged_attention_mq(q, pages[0], pages[1], tb,
                                                 ln, *pages[2:])
                    torch.cuda.synchronize()
                    if B > 1 and got[-1, 0].any():   # length 0: no key
                        raise AssertionError(f"paged_attention_mq_int8 Hq={Hq} "
                                             f"W={W}: dead slot not zero")
                    key = str(dtype).split(".")[-1]
                    errs[key] = max(errs.get(key, 0.0), check(
                        "paged_attention_mq_int8",
                        f"Hq={Hq} Hkv={Hkv} D={D} W={W} B={B} {dtype}", got,
                        ref.paged_attention_mq(q, pages[0], pages[1], tb, ln,
                                               *pages[2:]), dtype))
    return errs


def phase_small(dev) -> None:
    model = build_model(smoke_config("qwen2-7b"))
    cpu_params = model.init(0, device="cpu")
    prompts = [[5, 17, 33, 2, 9], [100, 200, 300], [7] * 11, list(range(40))]

    def serve(device, **kw):
        params = tree_map(lambda t: t.to(device), cpu_params)
        with ServeEngine(model, params, max_slots=3, max_len=128,
                         page_size=PS, prefill_chunk=16, device=device,
                         **kw) as eng:
            for p in prompts:
                eng.submit(p, max_new_tokens=8)
            return {r.rid: r.output for r in eng.run_until_drained()}

    for label, kw in (("paged", {}), ("dense", {"paged": False})):
        want, got = serve("cpu", **kw), serve(dev, **kw)
        if got != want:
            raise AssertionError(f"SMOKE {label} engine on the card {got} "
                                 f"!= CPU {want}")
        log(f"small input, {label}: card streams == CPU streams (SMOKE "
            f"qwen2-7b, float32)")


def check_served(eng, label: str, counts: dict, kernels) -> None:
    """The launcher's 8 requests finished with 32 valid tokens each, the
    path's ``kernels`` launched, no other counted kernel and no plain
    version ran, and the prefix cache hit."""
    cfg, done = eng.model.cfg, eng.finished
    if len(done) != 8 or any(r.error is not None for r in done):
        raise AssertionError(f"{label}: {len(done)} finished, errors "
                             f"{[r.error for r in done if r.error]}")
    for r in done:
        if len(r.output) != 32 or not all(0 <= t < cfg.vocab for t in r.output):
            raise AssertionError(f"{label} request {r.rid}: bad output "
                                 f"{r.output}")
    for name, (kernel, plain) in counts.items():
        if (kernel <= 0) == (name in kernels) or plain != 0:
            raise AssertionError(f"{label}: {name} launched {kernel} times, "
                                 f"plain version ran {plain} times")
    if eng.stats["prefix_hits"] <= 0:
        raise AssertionError(f"{label}: no prefix-cache hit")


def serve_main(extra=()):
    """The launcher on MAIN_ARGS (plus ``extra``) with the counts and the
    peak-memory mark zeroed first: (engine, launch counts, wall seconds,
    peak device bytes)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    eng = launch_serve.main(MAIN_ARGS + list(extra))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: (c.kernel, c.plain) for k, c in ops.COUNTS.items()}
    return eng, counts, wall, torch.cuda.max_memory_allocated()


def check_norm_counts(label: str, counts: dict, steps: int,
                      per_step: tuple[int, int, int]) -> None:
    """B2 ran ``per_step`` (standalone norms, fused add + norm, gated norms)
    times each of the run's ``steps`` prefills, prefill chunks and decode
    steps, every call as a kernel launch."""
    c = {k: counts[k] for k in ("rmsnorm", "rmsnorm_add", "rmsnorm_gated")}
    got = (c["rmsnorm"][0] - c["rmsnorm_add"][0] - c["rmsnorm_gated"][0],
           c["rmsnorm_add"][0], c["rmsnorm_gated"][0])
    want = tuple(n * steps for n in per_step)
    if got != want or any(plain for _, plain in c.values()):
        raise AssertionError(f"{label}: B2 (standalone, add, gated) launches "
                             f"{got} over {steps} steps, want {want} "
                             f"({per_step} a step); counts {c}")


def qwen_norms(cfg) -> tuple[int, int, int]:
    """B2's launches a qwen2 step: the first block's ln1 alone, every other
    norm (the other ln1s, each ln2, the final norm) with its residual add."""
    return 1, 2 * cfg.n_layers, 0


def check_split(label: str, counts: dict, name: str, P: int) -> None:
    """Every paged-attention call of the run split over more than one key
    range: the shapes-only split count of the table is above 1, and the
    split sub-count equals the calls."""
    from repro_torch.kernels.paged_attention import split_count
    n = split_count(P, PS)
    if n <= 1 or counts["paged_attention_mq_split"][0] != counts[name][0]:
        raise AssertionError(f"{label}: {n} splits for a table of {P} pages, "
                             f"{counts['paged_attention_mq_split'][0]} split "
                             f"calls of {counts[name][0]} {name} calls")


def served_rate(eng) -> float:
    """Requests a second the engine served closed-loop: its finished
    requests over first submit to last retirement."""
    done = eng.finished
    span = max(r.done_at for r in done) - min(r.submitted_at for r in done)
    return len(done) / span


def phase_main():
    eng, counts, wall, peak = serve_main()
    check_served(eng, "main path", counts, PAGED_KERNELS)
    check_split("main path", counts, "paged_attention_mq",
                eng.sched.pages_per_slot)
    cfg, done = eng.model.cfg, eng.finished
    toks = sum(len(r.output) for r in done)
    s = eng.stats
    check_norm_counts("main path", counts, s["ticks"] + s["chunk_prefills"],
                      qwen_norms(cfg))
    log(f"main path: qwen2-7b {cfg.n_layers} layers {cfg.dtype}, {len(done)} "
        f"requests, {toks} tokens, {toks / wall:.1f} tok/s wall "
        f"(init included: {wall:.2f}s), ticks={s['ticks']} "
        f"chunks={s['chunk_prefills']} pages_high_water="
        f"{s['pages_high_water']} prefix_hits={s['prefix_hits']} "
        f"max_memory_allocated={peak} B; {served_rate(eng):.2f} requests/s "
        f"served closed-loop; launches {counts}")
    return {k: v[0] for k, v in counts.items()}, eng, peak


def layer0_kv(eng, prompt) -> dict:
    """Layer 0's K and V rows of ``prompt`` from the pages ``eng``'s prefix
    cache holds for it (dequantized when int8), float32 on the host, with
    the int8 scales (None for float pages): {name: (rows, scales)}."""
    pool = eng.pool
    pages, n = pool.prefix.match(np.asarray(prompt, np.int32))
    n = min(n, len(prompt))
    idx = torch.tensor(pages, dtype=torch.long, device=eng.device)
    out = {}
    for name in ("k", "v"):
        rows = pool.storage[name][0, idx].flatten(0, 1)[:n]
        scale = None
        if eng.kv_quant is not None:
            scale = pool.storage[name + "_scale"][0, idx].flatten(0, 1)[:n]
            rows = eng.kv_quant.dequantize(rows, scale)
            scale = scale.cpu()
        out[name] = (rows.float().cpu(), scale)
    return out


def streams_agree(eng, want) -> str:
    """How far ``eng``'s greedy streams agree with ``want`` (rid -> tokens),
    as printed text."""
    got = {r.rid: r.output for r in eng.finished}
    same = sum(a == b for rid in got for a, b in zip(got[rid], want[rid]))
    first = [next((i for i, (a, b) in enumerate(zip(got[rid], want[rid]))
                   if a != b), len(got[rid])) for rid in sorted(got)]
    return (f"{same}/{sum(map(len, got.values()))} tokens equal, first "
            f"difference at token {first}")


def phase_main_int8(ref_kv, ref_streams, prompt):
    """The main run with int8 KV pages: served, through the int8 kernel
    only, 29568 KV bytes a token, and layer 0's dequantized K/V of
    ``prompt`` within half a step of the bf16 run's (``ref_kv``).  Returns
    the launch counts and the engine."""
    eng, counts, wall, peak = serve_main(["--kv-quant", "int8"])
    check_served(eng, "main-int8", counts, INT8_KERNELS)
    check_split("main-int8", counts, "paged_attention_mq_int8",
                eng.sched.pages_per_slot)
    s, cfg = eng.stats, eng.model.cfg
    if s["kv_bytes_per_token"] != INT8_KV_BYTES:
        raise AssertionError(f"main-int8: {s['kv_bytes_per_token']} KV bytes "
                             f"a token, want {INT8_KV_BYTES}")
    launches = counts["paged_attention_mq_int8"][0]
    if launches != cfg.n_layers * (s["ticks"] + s["chunk_prefills"]):
        raise AssertionError(f"main-int8: {launches} int8 attention launches "
                             f"for {s['ticks']} decode steps and "
                             f"{s['chunk_prefills']} chunks")
    got_kv, gaps = layer0_kv(eng, prompt), []
    for name in ("k", "v"):
        rows, scale = got_kv[name]
        want = ref_kv[name][0]
        n = min(len(rows), len(want))
        if n < PS:
            raise AssertionError(f"main-int8: only {n} cached layer-0 rows "
                                 "to compare")
        err = (rows[:n] - want[:n]).abs()
        limit = scale[:n, :, None] / 2 + 1e-6 * want[:n].abs()
        if not bool((err <= limit).all()):
            raise AssertionError(f"main-int8: layer-0 {name} beyond half a "
                                 f"step of bf16 ({(err - limit).max()})")
        gaps.append(f"{name}: {n} rows, max|d| {err.max().item():.3e}, max "
                    f"|d|/step {(err / scale[:n, :, None]).max().item():.4f}")
    toks = sum(len(r.output) for r in eng.finished)
    log(f"main-int8: qwen2-7b {cfg.n_layers} layers, int8 KV pages "
        f"({s['kv_bytes_per_token']} B a token), {len(eng.finished)} "
        f"requests, {toks} tokens, {toks / wall:.1f} tok/s wall (init "
        f"included: {wall:.2f}s), ticks={s['ticks']} "
        f"chunks={s['chunk_prefills']} pages_high_water="
        f"{s['pages_high_water']} prefix_hits={s['prefix_hits']} "
        f"max_memory_allocated={peak} B; launches {counts}; layer-0 K/V of "
        f"one prompt against the bf16 run's: {'; '.join(gaps)}; greedy "
        f"streams against the bf16 run: {streams_agree(eng, ref_streams)}")
    return {k: v[0] for k, v in counts.items()}, eng


def phase_main_int8w(bf16_peak, ref_streams):
    """The main run with int8 KV pages and int8 weights: served through the
    int8 kernel, at a lower peak device memory than the bf16 run."""
    eng, counts, wall, peak = serve_main(["--kv-quant", "int8",
                                          "--weight-quant", "int8"])
    check_served(eng, "main-int8w", counts, INT8_KERNELS)
    if peak >= bf16_peak:
        raise AssertionError(f"main-int8w: peak {peak} B, not below the bf16 "
                             f"run's {bf16_peak} B")
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(eng.params))
    s = eng.stats
    toks = sum(len(r.output) for r in eng.finished)
    log(f"main-int8w: int8 KV and int8 weights ({weights} B of weights), "
        f"{toks} tokens, {toks / wall:.1f} tok/s wall (init included: "
        f"{wall:.2f}s), ticks={s['ticks']} chunks={s['chunk_prefills']}, "
        f"max_memory_allocated={peak} B (bf16 run {bf16_peak} B); launches "
        f"{counts}; greedy streams against the bf16 run: "
        f"{streams_agree(eng, ref_streams)}")
    return eng


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

    out["rmsnorm"] = phase_timing_rmsnorm(dev)

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

    def library(q, kp, vp, tb, mask=mask):
        b = tb.shape[0]
        k = kp[tb.long()].reshape(b, -1, Hkv, D).transpose(1, 2)
        v = vp[tb.long()].reshape(b, -1, Hkv, D).transpose(1, 2)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k, v, attn_mask=mask[:b], enable_gqa=True)

    def library_int8(q, kq, vq, ks, vs, tb, mask=mask):
        """Composite yardstick: gather, dequantize (float32 multiply, cast
        to q's dtype) and scaled_dot_product_attention."""
        b, t = tb.shape[0], tb.long()
        k, v = ((c[t].float() * sc[t][..., None]).to(q.dtype)
                .reshape(b, -1, Hkv, D).transpose(1, 2)
                for c, sc in ((kq, ks), (vq, vs)))
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k, v, attn_mask=mask[:b], enable_gqa=True)

    int8_layers = [quantize_pages(kp.float(), vp.float())
                   for kp, vp in layers]
    nbytes, nops = attention_cost(q, layers[0][0], tb, ln)
    measure("paged_attention_mq", {
        "kernel": [lambda kv=kv: ops.paged_attention_mq(q, *kv, tb, ln)
                   for kv in layers],
        "plain": [lambda kv=kv: ref.paged_attention_mq(q, *kv, tb, ln)
                  for kv in layers],
        "library": [lambda kv=kv: library(q, *kv, tb) for kv in layers]},
        f"decode B={B} W={W} Hq={Hq} Hkv={Hkv} D={D} ps={PS} "
        f"lengths={lens.tolist()} bf16", nbytes, nops)
    nbytes, nops = attention_cost(q, int8_layers[0][0], tb, ln, scaled=True)
    measure("paged_attention_mq_int8", {
        "kernel": [lambda kv=kv: ops.paged_attention_mq(q, kv[0], kv[1], tb,
                                                        ln, *kv[2:])
                   for kv in int8_layers],
        "plain": [lambda kv=kv: ref.paged_attention_mq(q, kv[0], kv[1], tb,
                                                       ln, *kv[2:])
                  for kv in int8_layers],
        "library": [lambda kv=kv: library_int8(q, *kv, tb)
                    for kv in int8_layers]},
        f"decode B={B} W={W} Hq={Hq} Hkv={Hkv} D={D} ps={PS} "
        f"lengths={lens.tolist()} q bf16, int8 pages", nbytes, nops)

    # flash attention at the dense prefill's shapes: one whole prompt of a
    # bucket, every query head of every layer in one call, causal
    for S in (1024, 2048):
        fq = torch.randn(1, S, Hq, D, device=dev).to(dtype)
        fk = torch.randn(1, S, Hkv, D, device=dev).to(dtype)
        fv = torch.randn(1, S, Hkv, D, device=dev).to(dtype)
        nbytes = (2 * fq.numel() + fk.numel() + fv.numel()) * fq.element_size()
        nops = 4 * D * Hq * S * (S + 1) // 2          # visible pairs only
        measure("flash_attention" if S == 1024 else f"flash_attention S={S}", {
            "kernel": [lambda: ops.flash_attention(fq, fk, fv)] * 4,
            "plain": [lambda: ref.flash_attention(fq, fk, fv)] * 4,
            "library": [lambda: F.scaled_dot_product_attention(
                fq.transpose(1, 2), fk.transpose(1, 2), fv.transpose(1, 2),
                is_causal=True, enable_gqa=True)] * 4},
            f"prefill B=1 S={S} Hq={Hq} Hkv={Hkv} D={D} causal bf16",
            nbytes, nops)

    # the prefill-chunk shapes (one window of 64 at position 192): kept in
    # the B1 entries as chunk_*
    W2, start = 64, 192
    q2 = torch.randn(1, W2, Hq, D, device=dev).to(dtype)
    ln2 = torch.tensor([start + 1], dtype=torch.int32, device=dev)
    tb2 = tb[:1]
    mask2 = (torch.arange(P * PS, device=dev)[None, :]             # causal
             < start + 1 + torch.arange(W2, device=dev)[:, None])[None, None]
    for name, kvs, scaled, lib in (
            ("paged_attention_mq", layers, False,
             lambda kv: library(q2, *kv, tb2, mask=mask2)),
            ("paged_attention_mq_int8", int8_layers, True,
             lambda kv: library_int8(q2, *kv, tb2, mask=mask2))):
        b2, by2 = bound(*attention_cost(q2, kvs[0][0], tb2, ln2,
                                        scaled=scaled), dtype)
        t2 = {what: device_ms([lambda kv=kv: fn(kv) for kv in kvs])
              for what, fn in (
                  ("kernel", lambda kv: ops.paged_attention_mq(
                      q2, kv[0], kv[1], tb2, ln2, *kv[2:])),
                  ("plain", lambda kv: ref.paged_attention_mq(
                      q2, kv[0], kv[1], tb2, ln2, *kv[2:])),
                  ("library", lib))}
        out[name].update(chunk_ms=t2["kernel"], chunk_plain_ms=t2["plain"],
                         chunk_library_ms=t2["library"], chunk_bound_ms=b2,
                         chunk_shape=f"prefill chunk W={W2} start={start}")
        log(f"prefill-chunk shapes (device): {name} W={W2} start={start}: "
            f"{t2['kernel']:.5f} ms (plain {t2['plain']:.5f} ms, library "
            f"{'composite ' if scaled else ''}{t2['library']:.5f} ms, bound "
            f"{b2:.6f} ms by {by2})")

    # main-spec's full verify window (W 5) over the 4 decode slots: kept in
    # the B1 entries as verify_*
    W5 = max(VERIFY_WIDTHS)
    q5 = torch.randn(B, W5, Hq, D, device=dev).to(dtype)
    mask5 = (torch.arange(P * PS, device=dev)[None, None, :]         # causal
             < (ln[:, None] + torch.arange(W5, device=dev))[:, :, None]
             )[:, None]                                         # (B,1,W,S)
    for name, kvs, scaled, lib in (
            ("paged_attention_mq", layers, False,
             lambda kv: library(q5, *kv, tb, mask=mask5)),
            ("paged_attention_mq_int8", int8_layers, True,
             lambda kv: library_int8(q5, *kv, tb, mask=mask5))):
        b5, by5 = bound(*attention_cost(q5, kvs[0][0], tb, ln,
                                        scaled=scaled), dtype)
        t5 = {what: device_ms([lambda kv=kv: fn(kv) for kv in kvs])
              for what, fn in (
                  ("kernel", lambda kv: ops.paged_attention_mq(
                      q5, kv[0], kv[1], tb, ln, *kv[2:])),
                  ("plain", lambda kv: ref.paged_attention_mq(
                      q5, kv[0], kv[1], tb, ln, *kv[2:])),
                  ("library", lib))}
        host5 = time_ms(lambda: ops.paged_attention_mq(
            q5, kvs[0][0], kvs[0][1], tb, ln, *kvs[0][2:]))
        out[name].update(verify_ms=t5["kernel"], verify_plain_ms=t5["plain"],
                         verify_library_ms=t5["library"],
                         verify_bound_ms=b5, verify_bound_by=by5,
                         verify_host_ms=host5,
                         verify_shape=f"verify B={B} W={W5} P={P} "
                         f"lengths={lens.tolist()}")
        log(f"verify-window shapes (device): {name} B={B} W={W5} Hq={Hq} "
            f"Hkv={Hkv} D={D} P={P}: {t5['kernel']:.5f} ms (plain "
            f"{t5['plain']:.5f} ms, library "
            f"{'composite ' if scaled else 'gather + SDPA '}"
            f"{t5['library']:.5f} ms, bound {b5:.6f} ms by {by5}); "
            f"host-issued kernel {host5:.5f} ms")
    return out


def norm_case(name, rows, d, dev):
    """(args, bytes, operations) of one B2 call: bf16 x (and delta), or
    float32 y and bf16 z for the gated norm; a bf16 scale.  Bytes: each
    input read once and each output written once; operations: the float32
    arithmetic an element (the norm's 4, the add's 1, the gate's silu,
    roundings and product 6); the final norm writes no sum."""
    bf16 = torch.bfloat16
    scale = torch.randn(d, device=dev).to(bf16)
    if name == "rmsnorm":
        return ((torch.randn(rows, d, device=dev).to(bf16), scale),
                rows * d * 4 + d * 2, 4 * rows * d)
    if name in ("add_rmsnorm", "final_rmsnorm"):
        return ((torch.randn(rows, d, device=dev).to(bf16),
                 torch.randn(rows, d, device=dev).to(bf16), scale),
                rows * d * (8 if name == "add_rmsnorm" else 6) + d * 2,
                5 * rows * d)
    return ((torch.randn(rows, d, device=dev),
             torch.randn(rows, d, device=dev).to(bf16), scale),
            rows * d * 8 + d * 2, 10 * rows * d)


def norm_fns(name):
    """(kernel wrapper, plain version) of one timed B2 variant."""
    if name == "final_rmsnorm":
        return (functools.partial(ops.add_rmsnorm, keep_sum=False),
                functools.partial(ref.add_rmsnorm, keep_sum=False))
    return getattr(ops, name), getattr(ref, name)


def phase_timing_rmsnorm(dev) -> dict:
    """B2's three variants at every (rows, d) the main runs launch them with
    (NORM_TIMED): device time of 8 calls on distinct inputs from a replayed
    CUDA graph and the host-issued time, beside the plain version, the
    yardstick (``F.rms_norm``; for the fused variants the ops they replace,
    ending in ``F.rms_norm``), the bytes bound and a launch floor (a
    1-element PyTorch op in the same harness).  The headline is the plain
    norm at the decode shape, where its first port was timed."""
    import torch.nn.functional as F
    one = torch.zeros(1, device=dev)
    floor = device_ms([lambda: one.add_(1)] * 8)
    floor_host = time_ms(lambda: one.add_(1))
    log(f"timing launch floor (a 1-element add_): device {floor:.5f} ms, "
        f"host-issued {floor_host:.5f} ms")

    def library(name, *a):
        if name == "rmsnorm":
            x, sc = a
            return F.rms_norm(x, sc.shape, sc, 1e-6)
        if name == "add_rmsnorm":
            x, dl, sc = a
            s = x + dl
            return s, F.rms_norm(s, sc.shape, sc, 1e-6)
        if name == "final_rmsnorm":
            x, dl, sc = a
            return F.rms_norm(x + dl, sc.shape, sc, 1e-6)
        y, z, sc = a
        return F.rms_norm(y.to(z.dtype) * F.silu(z), sc.shape, sc, 1e-6)

    variants = {}
    for name, shapes in NORM_TIMED.items():
        kernel, plain = norm_fns(name)
        for rows, d in shapes:
            cases = [norm_case(name, rows, d, dev) for _ in range(8)]
            nbytes, nops = cases[0][1:]
            fns = {"kernel": [lambda a=c[0]: kernel(*a) for c in cases],
                   "plain": [lambda a=c[0]: plain(*a) for c in cases],
                   "library": [lambda a=c[0]: library(name, *a)
                               for c in cases]}
            t = {k: device_ms(v) for k, v in fns.items()}
            host = {k: time_ms(fns[k][0]) for k in ("kernel", "library")}
            b_ms, b_by = bound(nbytes, nops, torch.float32)
            key = f"{name} rows={rows} d={d}"
            variants[key] = dict(
                ms=t["kernel"], host_ms=host["kernel"], plain_ms=t["plain"],
                library_ms=t["library"], library_host_ms=host["library"],
                bound_ms=b_ms, bound_by=b_by, of_bound=b_ms / t["kernel"])
            log(f"timing {key} ({'y f32, z' if name == 'gated_rmsnorm' else 'x'}"
                f" bf16): device kernel {t['kernel']:.5f} ms, plain "
                f"{t['plain']:.5f} ms, yardstick {t['library']:.5f} ms, bound "
                f"{b_ms:.6f} ms ({b_by}; the kernel at "
                f"{b_ms / t['kernel']:.1%} of it); host-issued kernel "
                f"{host['kernel']:.5f} ms, yardstick {host['library']:.5f} ms")
            del cases, fns
    rows, d = NORM_TIMED["rmsnorm"][0]
    head = variants[f"rmsnorm rows={rows} d={d}"]
    return dict(ms=head["ms"], plain_ms=head["plain_ms"],
                library_ms=head["library_ms"], bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], shape=f"x ({rows}, {d}) bf16",
                floor_ms=floor, floor_host_ms=floor_host, variants=variants)


def norm_ms(times, name, rows, d) -> float:
    """B2's device time of one variant at (rows, d) from the timing phase."""
    return times["rmsnorm"]["variants"][f"{name} rows={rows} d={d}"]["ms"]


def step_norms_ms(times, per_step, rows, d, di=None) -> float:
    """B2's device time in one step of ``per_step`` (standalone, fused add,
    gated) launches at ``rows``: the last fused add is the final norm's."""
    alone, add, gated = per_step
    return (alone * norm_ms(times, "rmsnorm", rows, d)
            + (add - 1) * norm_ms(times, "add_rmsnorm", rows, d)
            + norm_ms(times, "final_rmsnorm", rows, d)
            + (gated * norm_ms(times, "gated_rmsnorm", rows, di)
               if gated else 0.0))


def phase_step(eng, times, label: str = "") -> None:
    """One decode step and one prefill chunk of ``eng``'s model (its KV
    quantization and weights), timed as the host issues them and as a
    replayed CUDA graph (device time), with the two kernels' share of the
    device time."""
    model, params, storage = eng.model, eng.params, eng.pool.storage
    kw = {} if eng.kv_quant is None else {"quant": eng.kv_quant}
    attn = "paged_attention_mq" if eng.kv_quant is None \
        else "paged_attention_mq_int8"
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
                                       wp, wo, **kw)

    start, C = 192, 64
    row = tables[0]
    pages = row[start // PS:(start + C) // PS]
    chunk = torch.tensor(rng.integers(0, cfg.vocab, (1, C)).astype(np.int32),
                         device=dev)

    def prefill():
        return model.paged_prefill_chunk(params, storage, row, pages, start,
                                         chunk, **kw)

    L, d = cfg.n_layers, cfg.d_model
    for name, fn, rows in (("decode step (4 slots)", decode, 4),
                           ("prefill chunk (64 at 192)", prefill, 64)):
        host = time_ms(fn, iters=10, warmup=2)
        devt = device_ms([fn], reps=10)
        norms = step_norms_ms(times, qwen_norms(cfg), rows, d)
        log(f"{label}{name}: host-issued {host:.3f} ms, device {devt:.3f} ms "
            f"(card idle {max(0.0, 1 - devt / host):.1%} of the host-issued "
            f"time); B2's 1 rmsnorm + {2 * L - 1} add_rmsnorm + 1 "
            f"final_rmsnorm launches at their device times = {norms:.4f} ms")
    kernels = L * times[attn]["ms"] + step_norms_ms(times, qwen_norms(cfg),
                                                    4, d)
    log(f"{label}decode step: {L} {attn} + 1 rmsnorm + {2 * L - 1} "
        f"add_rmsnorm + 1 final_rmsnorm launches at their device times = "
        f"{kernels:.3f} ms")


def phase_main_dense():
    """The dense per-slot path through the launcher, counts from 0; then
    the paged engine on the same weights and prompts, for the streams'
    agreement (printed, not gated: bf16 near-ties may flip a token)."""
    args = launch_serve.parse_args(DENSE_ARGS)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    eng = launch_serve.main(DENSE_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: (c.kernel, c.plain) for k, c in ops.COUNTS.items()}
    peak = torch.cuda.max_memory_allocated()
    cfg = eng.model.cfg
    done = eng.finished
    prompts = launch_serve.make_prompts(args, cfg.vocab)
    if not all(964 <= len(p) <= 1007 for p in prompts):
        raise AssertionError(f"main-dense: prompt lengths "
                             f"{[len(p) for p in prompts]} leave bucket 1024")
    if len(done) != 8 or any(r.error is not None for r in done):
        raise AssertionError(f"main-dense: {len(done)} finished, errors "
                             f"{[r.error for r in done if r.error]}")
    for r in done:
        if len(r.output) != 32 or not all(0 <= t < cfg.vocab for t in r.output):
            raise AssertionError(f"main-dense request {r.rid}: bad output "
                                 f"{r.output}")
    prefills = eng.stats["prefills"]
    if (prefills != 8 or counts["flash_attention"] != (cfg.n_layers * 8, 0)
            or counts["flash_attention_tc"] != (cfg.n_layers * 8, 0)):
        raise AssertionError(f"main-dense: {prefills} prefills, "
                             f"flash_attention (launches, plain) "
                             f"{counts['flash_attention']}, on the tensor "
                             f"cores {counts['flash_attention_tc']}, want "
                             f"({cfg.n_layers * 8}, 0) for both")
    if any(p for _, p in counts.values()) or any(
            k for name, (k, _) in counts.items()
            if name not in ("flash_attention", "flash_attention_tc",
                            "rmsnorm", "rmsnorm_add")):
        raise AssertionError(f"main-dense: launches {counts}")
    check_norm_counts("main-dense", counts, prefills + eng.stats["ticks"],
                      qwen_norms(cfg))
    with ServeEngine(eng.model, eng.params, max_slots=args.slots,
                     max_len=args.max_len, page_size=PS, prefill_chunk=64,
                     device=args.device) as paged:
        for p in prompts:
            paged.submit(p, max_new_tokens=args.max_new)
        want = {r.rid: r.output for r in paged.run_until_drained()}
    k_gaps = prefill_k_gaps(eng, prompts[0])
    farm = farm_runs(eng, args, prompts)
    got = {r.rid: r.output for r in done}
    same = sum(a == b for rid in got for a, b in zip(got[rid], want[rid]))
    prefix = [next((i for i, (a, b) in enumerate(zip(got[rid], want[rid]))
                    if a != b), 32) for rid in sorted(got)]
    toks = sum(len(r.output) for r in done)
    log(f"main-dense: qwen2-7b {cfg.n_layers} layers {cfg.dtype}, "
        f"{len(done)} requests of {min(map(len, prompts))}-"
        f"{max(map(len, prompts))} prompt tokens (bucket 1024), {toks} "
        f"tokens, {toks / wall:.1f} tok/s wall (init included: "
        f"{wall:.2f}s), ticks={eng.stats['ticks']} prefills={prefills}, "
        f"max_memory_allocated={peak} B; launches {counts} "
        f"({counts['flash_attention'][0] // prefills} flash_attention a "
        f"prefill, {counts['flash_attention_tc'][0]} launches on the tensor "
        f"cores); dense vs paged greedy streams on the same prompts: "
        f"{same}/{toks} tokens equal, first difference at token {prefix}")
    log("main-dense, float32, one prompt of "
        f"{len(prompts[0])} tokens: flash kernel vs plain version, max|dK| "
        "/ max|K| by layer: " + " ".join(f"{g:.2e}" for g in k_gaps)
        + f" (layer 1 gated at {K_GAP_TOL})")
    for workers, wall_s, ttft_s in farm:
        log(f"main-dense prefill farm, {workers} worker(s): 8 requests in "
            f"{wall_s:.4f} s wall, mean TTFT {ttft_s * 1e3:.2f} ms")
    return {k: v[0] for k, v in counts.items()}, eng


def prefill_k_gaps(eng, prompt) -> list[float]:
    """Per-layer max|dK| / max|K| between a float32 prefill of ``prompt``
    (bucket-padded) through the flash kernel and one through its plain
    version, on ``eng``'s weights; raises if layer 1 exceeds K_GAP_TOL."""
    cfg = eng.model.cfg.replace(dtype="float32")
    model = build_model(cfg)
    params = tree_map(lambda t: t.float(), eng.params)
    n = len(prompt)
    toks = np.zeros((1, 1024), np.int32)
    toks[0, :n] = prompt
    toks = torch.tensor(toks, device=eng.device)
    kernel_k = model.prefill(params, toks)[0]["k"][:, 0, :n]
    launch = ops.flash_attention
    ops.flash_attention = ref.flash_attention      # the same call, plain
    try:
        plain_k = model.prefill(params, toks)[0]["k"][:, 0, :n]
    finally:
        ops.flash_attention = launch
    gaps = [((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(kernel_k, plain_k)]
    del params, kernel_k, plain_k
    gc.collect()
    torch.cuda.empty_cache()
    if not gaps[1] <= K_GAP_TOL:
        raise AssertionError(f"main-dense: layer-1 K of the flash kernel's "
                             f"prefill is {gaps[1]} (relative) from the "
                             f"plain version's, limit {K_GAP_TOL}")
    return gaps


def farm_runs(eng, args, prompts) -> list[tuple[int, float, float]]:
    """(workers, wall seconds, mean TTFT seconds) of the main-dense requests
    served on ``eng``'s weights with each of FARM_WORKERS prefill workers."""
    runs = []
    for workers in FARM_WORKERS:
        with ServeEngine(eng.model, eng.params, max_slots=args.slots,
                         max_len=args.max_len, paged=False,
                         prefill_workers=workers,
                         device=args.device) as dense:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for p in prompts:
                dense.submit(p, max_new_tokens=args.max_new)
            done = dense.run_until_drained()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if len(done) != len(prompts) or any(r.error for r in done):
            raise AssertionError(f"main-dense, {workers} workers: "
                                 f"{len(done)} finished")
        runs.append((workers, wall, float(np.mean(
            [r.first_token_at - r.submitted_at for r in done]))))
    return runs


def phase_step_dense(eng, times) -> None:
    """One dense decode step over 4 slots of max_len 2048 and one
    whole-prompt prefill at bucket 1024, host-issued and as device time,
    with the flash-attention kernel's share of the prefill."""
    model, params, state = eng.model, eng.params, eng.state
    cfg, dev = model.cfg, eng.device
    rng = np.random.default_rng(3)
    B = eng.max_slots
    pos = torch.tensor([1000, 990, 1010, 980][:B], dtype=torch.int32,
                       device=dev)
    toks = torch.tensor(rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32),
                        device=dev)
    prompt = torch.tensor(rng.integers(0, cfg.vocab, (1, 1024))
                          .astype(np.int32), device=dev)
    L, d = cfg.n_layers, cfg.d_model
    for name, fn, rows in (
            (f"dense decode step ({B} slots, max_len {eng.max_len})",
             lambda: model.decode_step(params, state, toks, pos), B),
            ("dense prefill (bucket 1024)",
             lambda: model.prefill(params, prompt), 1024)):
        host = time_ms(fn, iters=10, warmup=2)
        devt = device_ms([fn], reps=10)
        norms = step_norms_ms(times, qwen_norms(cfg), rows, d)
        log(f"{name}: host-issued {host:.3f} ms, device {devt:.3f} ms "
            f"(card idle {max(0.0, 1 - devt / host):.1%} of the host-issued "
            f"time); B2's 1 rmsnorm + {2 * L - 1} add_rmsnorm + 1 "
            f"final_rmsnorm launches at their device times = {norms:.4f} ms")
    log(f"dense prefill: {cfg.n_layers} flash_attention launches at their "
        f"device time = {cfg.n_layers * times['flash_attention']['ms']:.3f} "
        f"ms")


# -- rwkv6: the dense path of a recurrent family, kernel B4 --------------------

def rwkv_case(rng, dev, dtype, B, S, H, K, V, planted=0):
    """r, k, v in ``dtype``; a decay spanning about e^-20 to 1, as
    exp(-exp(x)) with x ~ N(0, 1) gives it at full width, with ``planted``
    exact zeros and as many denormals put into it; u and a nonzero initial
    state (float32)."""
    f = np.float32
    r, k, v = (torch.from_numpy(rng.normal(size=(B, S, H, C)).astype(f))
               .to(dev, dtype) for C in (K, K, V))
    w = np.exp(-np.exp(rng.normal(size=(B, S, H, K)))).astype(f)
    if planted:
        flat = w.reshape(-1)
        at = rng.choice(flat.size, 2 * planted, replace=False)
        flat[at[:planted]] = 0.0
        flat[at[planted:]] = rng.uniform(1e-45, 1e-39, planted).astype(f)
    w = torch.from_numpy(w).to(dev)
    u = torch.from_numpy(rng.normal(size=(H, K)).astype(f)).to(dev)
    s0 = torch.from_numpy(rng.normal(size=(B, H, K, V)).astype(f)).to(dev)
    return r, k, v, w, u, s0


def rel_gap(got, want) -> tuple[float, float]:
    """(max |d|, max |d| / max(1, max |want|))."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(1.0, want.float().abs().max().item())


def phase_parity_rwkv(dev) -> dict:
    """The wkv kernel against its plain version at RWKV_CASES and
    RWKV_PLANTED, r/k/v in bf16 and float32, from a nonzero state written
    in place (the decode step's use) and from zeros; each call's route
    checked by the ``rwkv6_scan_tc`` sub-count.  Max abs and relative
    errors by dtype."""
    from repro_torch.kernels.rwkv6_scan import tensor_core_route
    rng = np.random.default_rng(4)
    errs = {}
    cases = [c + (0,) for c in RWKV_CASES] + RWKV_PLANTED
    for dtype in (torch.bfloat16, torch.float32):
        key = str(dtype).split(".")[-1]
        for B, S, H, K, V, planted in cases:
            r, k, v, w, u, s0 = rwkv_case(rng, dev, dtype, B, S, H, K, V,
                                          planted)
            want_y, want_s = ref.rwkv6_scan(r, k, v, w, u, s0)
            zero_y, zero_s = ref.rwkv6_scan(r, k, v, w, u)
            state = s0.clone()
            ops.reset_counts()
            y, st = ops.rwkv6_scan(r, k, v, w, u, state, out_state=state)
            y0, st0 = ops.rwkv6_scan(r, k, v, w, u)
            torch.cuda.synchronize()
            if st is not state:
                raise AssertionError("rwkv6_scan: state not written in place")
            tc = ops.COUNTS["rwkv6_scan_tc"].kernel
            if tc != 2 * tensor_core_route(r, v) or (
                    (B, S, H) == (1, 1024, 40) and tc != 2):
                raise AssertionError(
                    f"rwkv6_scan B={B} S={S} H={H} K={K} V={V}: {tc} of 2 "
                    f"calls on the tensor-core route")
            if not (torch.isfinite(y).all() and torch.isfinite(st).all()):
                raise AssertionError(f"rwkv6_scan B={B} S={S} H={H} planted="
                                     f"{planted}: non-finite output")
            for what, got, want in (("y", y, want_y), ("state", state, want_s),
                                    ("y0", y0, zero_y), ("state0", st0, zero_s)):
                err, rel = rel_gap(got, want)
                if not rel <= RWKV_REL:
                    raise AssertionError(
                        f"rwkv6_scan B={B} S={S} H={H} K={K} V={V} planted="
                        f"{planted} {dtype} {what}: kernel disagrees with "
                        f"plain version (max abs err {err}, relative {rel}, "
                        f"limit {RWKV_REL})")
                a, b = errs.get(key, (0.0, 0.0))
                errs[key] = (max(a, err), max(b, rel))
    log(f"parity ok: {2 * len(cases)} rwkv6_scan cases "
        f"({2 * len(RWKV_PLANTED)} with zeros and denormals planted in w; "
        f"each from a state in place "
        f"and from zeros; K = V = 64 from S 64 on the tensor-core route, by "
        f"its sub-count), limit max|d| <= {RWKV_REL} x max(1, max|plain|); "
        f"(max abs err, max relative) by r/k/v dtype {errs}")
    return errs


def phase_small_rwkv(dev) -> None:
    model = build_model(smoke_config("rwkv6-3b"))
    cpu_params = model.init(0, device="cpu")
    prompts = [[5, 17, 33, 2, 9], [100, 200, 300], [7] * 11, list(range(40)),
               [1, 2]]

    def serve(device):
        params = tree_map(lambda t: t.to(device), cpu_params)
        with ServeEngine(model, params, max_slots=3, max_len=128,
                         device=device) as eng:
            for p in prompts:
                eng.submit(p, max_new_tokens=8)
            return {r.rid: r.output for r in eng.run_until_drained()}

    want, got = serve("cpu"), serve(dev)
    if got != want:
        raise AssertionError(f"SMOKE rwkv6-3b engine on the card {got} != "
                             f"CPU {want}")
    log("small input, rwkv: card streams == CPU streams (SMOKE rwkv6-3b, "
        "float32, dense path picked by itself)")


def phase_main_rwkv():
    """Full-width rwkv6-3b through the launcher, counts from 0: served,
    through the wkv kernel only, 32 launches a prefill or decode step;
    then the float32 prefill gaps between the kernel and its plain
    version."""
    args = launch_serve.parse_args(RWKV_ARGS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    eng = launch_serve.main(RWKV_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: (c.kernel, c.plain) for k, c in ops.COUNTS.items()}
    peak = torch.cuda.max_memory_allocated()
    cfg, done, s = eng.model.cfg, eng.finished, eng.stats
    prompts = launch_serve.make_prompts(args, cfg.vocab)
    if eng.paged or not all(964 <= len(p) <= 1007 for p in prompts):
        raise AssertionError(f"main-rwkv: paged={eng.paged}, prompt lengths "
                             f"{[len(p) for p in prompts]}")
    if len(done) != 8 or any(r.error is not None for r in done):
        raise AssertionError(f"main-rwkv: {len(done)} finished, errors "
                             f"{[r.error for r in done if r.error]}")
    for r in done:
        if len(r.output) != 32 or not all(0 <= t < cfg.vocab for t in r.output):
            raise AssertionError(f"main-rwkv request {r.rid}: bad output "
                                 f"{r.output}")
    steps = s["prefills"] + s["ticks"]
    # every prefill call (S 1024) on the tensor-core route, every decode
    # call (S 1) on the CUDA-core one
    want = {k: (0, 0) for k in counts}
    want["rwkv6_scan"] = (cfg.n_layers * steps, 0)
    want["rwkv6_scan_tc"] = (cfg.n_layers * s["prefills"], 0)
    if s["prefills"] != 8 or counts != want:
        raise AssertionError(f"main-rwkv: {s['prefills']} prefills, "
                             f"{s['ticks']} decode steps, launches {counts}, "
                             f"want {want}")
    gaps = rwkv_prefill_gaps(eng, prompts[0])
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(eng.params))
    toks = sum(len(r.output) for r in done)
    ttft = float(np.mean([r.first_token_at - r.submitted_at for r in done]))
    log(f"main-rwkv: rwkv6-3b {cfg.n_layers} layers {cfg.dtype}, {len(done)} "
        f"requests of {min(map(len, prompts))}-{max(map(len, prompts))} "
        f"prompt tokens (bucket 1024), {toks} tokens, {toks / wall:.1f} tok/s "
        f"wall (init included: {wall:.2f}s), mean TTFT {ttft * 1e3:.2f} ms, "
        f"ticks={s['ticks']} prefills={s['prefills']}, {weights} B of "
        f"weights, max_memory_allocated={peak} B; launches {counts} "
        f"({cfg.n_layers} x {steps} prefills and decode steps: "
        f"{counts['rwkv6_scan_tc'][0]} prefill calls on the tensor-core "
        f"route, {counts['rwkv6_scan'][0] - counts['rwkv6_scan_tc'][0]} "
        f"decode calls on the CUDA-core one)")
    log("main-rwkv, float32, one prompt of "
        f"{len(prompts[0])} tokens (bucket 1024): wkv kernel vs plain "
        "version, final wkv state max|dS| / max|S| by layer: "
        + " ".join(f"{g:.2e}" for g in gaps)
        + f" (layer 0 gated at {RWKV_REL})")
    return {k: counts[k][0] for k in ("rwkv6_scan", "rwkv6_scan_tc")}, eng


def rwkv_prefill_gaps(eng, prompt) -> list[float]:
    """Per-layer max|dS| / max|S| of the final wkv state between a float32
    prefill of ``prompt`` (bucket-padded, as the engine pads it) through
    the kernel and one through its plain version, on ``eng``'s weights;
    raises if layer 0 exceeds RWKV_REL."""
    model = build_model(eng.model.cfg.replace(dtype="float32"))
    params = tree_map(lambda t: t.float(), eng.params)
    toks = np.zeros((1, 1024), np.int32)
    toks[0, :len(prompt)] = prompt
    toks = torch.tensor(toks, device=eng.device)
    kernel_s = model.prefill(params, toks)[0]["wkv"][:, 0]
    launch = ops.rwkv6_scan
    ops.rwkv6_scan = ref.rwkv6_scan                  # the same call, plain
    try:
        plain_s = model.prefill(params, toks)[0]["wkv"][:, 0]
    finally:
        ops.rwkv6_scan = launch
    gaps = [((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(kernel_s, plain_s)]
    del params, kernel_s, plain_s
    gc.collect()
    torch.cuda.empty_cache()
    if not gaps[0] <= RWKV_REL:
        raise AssertionError(f"main-rwkv: layer-0 wkv state of the kernel's "
                             f"prefill is {gaps[0]} (relative) from the plain "
                             f"version's, limit {RWKV_REL}")
    return gaps


def wkv_chunked(r, k, v, w, u, state, chunk: int = 32):
    """Composite yardstick, timed only: the reference's chunked matmul form
    of the recurrence (``repro/models/rwkv6.py:_wkv_chunked``) in torch,
    float32.  Its ``exp(-cumsum(log w))`` overflows where a chunk's decays
    multiply below about e^-88, as the full-width decay range allows, so
    its values are not compared."""
    B, S, H, K = r.shape
    nc = S // chunk

    def chunks(t):                              # (B, S, H, C) -> (nc, B, Q, H, C)
        return t.float().reshape(B, nc, chunk, H, t.shape[-1]).transpose(0, 1)

    rc, kc, vc = chunks(r), chunks(k), chunks(v)
    lw = chunks(torch.log(torch.clamp(w, min=1e-30)))
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=r.device), -1)
    ys = []
    for c in range(nc):
        r_, k_, v_, lw_ = rc[c], kc[c], vc[c], lw[c]
        cs = torch.cumsum(lw_, dim=1)
        r_t = r_ * torch.exp(cs - lw_)
        k_t = k_ * torch.exp(-cs)
        A = torch.einsum("bqhk,bjhk->bhqj", r_t, k_t).masked_fill(~mask, 0.0)
        diag = torch.einsum("bqhk,bqhk->bqh", r_ * u, k_)
        y = torch.einsum("bhqj,bjhv->bqhv", A, v_) + diag[..., None] * v_
        ys.append(y + torch.einsum("bqhk,bhkv->bqhv", r_t, state))
        k_end = k_ * torch.exp(cs[:, -1:] - cs)
        state = state * torch.exp(cs[:, -1])[..., None] \
            + torch.einsum("bqhk,bqhv->bhkv", k_end, v_)
    return torch.stack(ys, 1).reshape(B, S, H, -1), state


def wkv_cost(B, S, H, K, V, rkv_bytes) -> tuple[int, int]:
    """(bytes, operations) of one wkv call: r, k, v read once in their
    dtype, w and y float32, u, the state read and written; 5 flops a state
    element and step (y += r S; S = w S + k v) plus 2K + 2V for the bonus
    term r . (u o k) v."""
    nbytes = (B * S * H * (2 * K + V) * rkv_bytes + B * S * H * K * 4
              + B * S * H * V * 4 + H * K * 4 + 2 * B * H * K * V * 4)
    return nbytes, B * S * H * (5 * K * V + 2 * K + 2 * V)


def phase_timing_rwkv(dev) -> dict:
    """The wkv kernel, its plain version and the composite yardstick at the
    main-rwkv prefill shape (B 1, S 1024, H 40, K = V 64, bf16 r/k/v), and
    kernel and plain at the decode shape (B 4, S 1), one state per layer
    (32 states: more than the 50 MB L2), as device time."""
    cfg = get_config("rwkv6-3b")
    H, K = cfg.rwkv_heads, cfg.rwkv_head_dim
    rng = np.random.default_rng(5)
    r, k, v, w, u, s0 = rwkv_case(rng, dev, torch.bfloat16, 1, 1024, H, K, K)
    t = {"kernel": device_ms([lambda: ops.rwkv6_scan(r, k, v, w, u, s0)] * 4),
         "plain": device_ms([lambda: ref.rwkv6_scan(r, k, v, w, u, s0)],
                            reps=5),
         "composite": device_ms([lambda: wkv_chunked(r, k, v, w, u, s0)] * 4)}
    eager = time_ms(lambda: ops.rwkv6_scan(r, k, v, w, u, s0))
    cost = wkv_cost(1, 1024, H, K, K, 2)
    b_ms, b_by = bound(*cost, "tf32")             # its route: tensor cores
    f32_ms, f32_by = bound(*cost, torch.float32)  # the CUDA-core route's
    shape = f"prefill B=1 S=1024 H={H} K=V={K} r/k/v bf16"
    log(f"timing rwkv6_scan [{shape}, tensor-core route]: device kernel "
        f"{t['kernel']:.5f} ms (3 launches), plain {t['plain']:.5f} ms, "
        f"composite (chunked torch) {t['composite']:.5f} ms, bound "
        f"{b_ms:.6f} ms ({b_by}, operations at the TF32 peak; at the float32 "
        f"CUDA-core peak {f32_ms:.6f} ms, {f32_by}); host-issued kernel "
        f"{eager:.5f} ms")
    layers = [rwkv_case(rng, dev, torch.bfloat16, 4, 1, H, K, K)
              for _ in range(cfg.n_layers)]
    d = {"kernel": device_ms([lambda a=a: ops.rwkv6_scan(*a[:5], a[5],
                                                         out_state=a[5])
                              for a in layers]),
         "plain": device_ms([lambda a=a: ref.rwkv6_scan(*a[:5], a[5], a[5])
                             for a in layers])}
    db_ms, db_by = bound(*wkv_cost(4, 1, H, K, K, 2), torch.float32)
    log(f"timing rwkv6_scan [decode B=4 S=1 H={H} K=V={K}, state in place]: "
        f"device kernel {d['kernel']:.5f} ms, plain {d['plain']:.5f} ms, "
        f"bound {db_ms:.6f} ms ({db_by})")
    return dict(ms=t["kernel"], plain_ms=t["plain"], library_ms=None,
                composite_ms=t["composite"], bound_ms=b_ms, bound_by=b_by,
                bound_f32_ms=f32_ms, shape=shape, decode_ms=d["kernel"],
                decode_plain_ms=d["plain"], decode_bound_ms=db_ms)


def phase_step_rwkv(eng, times) -> None:
    """One rwkv decode step over the engine's 4 slots and one bucket-1024
    prefill, host-issued and as device time, with the wkv kernel's share."""
    model, params, state = eng.model, eng.params, eng.state
    cfg, dev = model.cfg, eng.device
    rng = np.random.default_rng(6)
    B = eng.max_slots
    toks = torch.tensor(rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32),
                        device=dev)
    prompt = torch.tensor(rng.integers(0, cfg.vocab, (1, 1024))
                          .astype(np.int32), device=dev)
    for name, fn in (
            (f"rwkv decode step ({B} slots)",
             lambda: model.decode_step(params, state, toks)),
            ("rwkv prefill (bucket 1024)",
             lambda: model.prefill(params, prompt))):
        host = time_ms(fn, iters=10, warmup=2)
        devt = device_ms([fn], reps=10)
        log(f"{name}: host-issued {host:.3f} ms, device {devt:.3f} ms "
            f"(card idle {max(0.0, 1 - devt / host):.1%} of the host-issued "
            f"time)")
    log(f"rwkv: {cfg.n_layers} rwkv6_scan launches at their device times = "
        f"{cfg.n_layers * times['decode_ms']:.3f} ms a decode step, "
        f"{cfg.n_layers * times['ms']:.3f} ms a prefill")


# -- zamba2: Mamba-2 layers and the shared block as an aligned batch, B5 ------

def ssd_case(rng, dev, bc_dtype, B, S, H, P, N, decay=1.0):
    """zamba2's init statistics: dt = softplus(N(0, 1)), la = -decay dt
    (A_log 0 at decay 1), xdt = N(0, 1) * dt; B and C in ``bc_dtype``; a
    nonzero float32 initial state."""
    f = np.float32
    dt = np.log1p(np.exp(rng.normal(size=(B, S, H))))
    xdt = torch.from_numpy((rng.normal(size=(B, S, H, P)) * dt[..., None])
                           .astype(f)).to(dev)
    la = torch.from_numpy((-decay * dt).astype(f)).to(dev)
    bm, cm = (torch.from_numpy(rng.normal(size=(B, S, N)).astype(f))
              .to(dev, bc_dtype) for _ in range(2))
    s0 = torch.from_numpy(rng.normal(size=(B, H, N, P)).astype(f)).to(dev)
    return xdt, la, bm, cm, s0


def phase_parity_ssd(dev) -> dict:
    """The SSD kernel against its plain version at SSD_CASES, at
    SSD_SLOW_CASES (N = P = 64) and at every (N, P) the kernel is built for
    (B 2, S 70, H 3), B/C in bf16 and float32: from a nonzero state written
    in place (aliased, the decode step's use), from a given state into a
    fresh one, and from zeros; each call's route checked by the
    ``ssd_scan_tc`` sub-count.  Max abs and relative errors by B/C
    dtype."""
    from repro_torch.kernels.ssd_scan import tensor_core_route
    rng = np.random.default_rng(7)
    cases = ([c + (1.0,) for c in SSD_CASES]
             + [(B, S, H, 64, 64, 0.005) for B, S, H in SSD_SLOW_CASES]
             + [(2, 70, 3, P, N, 1.0) for P in (8, 16, 32, 64)
                for N in (4, 8, 16, 32, 64)])
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        key = str(dtype).split(".")[-1]
        for B, S, H, P, N, decay in cases:
            xdt, la, bm, cm, s0 = ssd_case(rng, dev, dtype, B, S, H, P, N,
                                           decay)
            want_y, want_s = ref.ssd_scan(xdt, la, bm, cm, s0)
            zero_y, zero_s = ref.ssd_scan(xdt, la, bm, cm)
            state = s0.clone()
            ops.reset_counts()
            y, st = ops.ssd_scan(xdt, la, bm, cm, state, out_state=state)
            y1, s1 = ops.ssd_scan(xdt, la, bm, cm, s0)
            y0, st0 = ops.ssd_scan(xdt, la, bm, cm)
            torch.cuda.synchronize()
            if st is not state:
                raise AssertionError("ssd_scan: state not written in place")
            tc = ops.COUNTS["ssd_scan_tc"].kernel
            if tc != 3 * tensor_core_route(xdt, bm) or (
                    (B, S, H, dtype) == (4, 1000, 112, torch.bfloat16)
                    and tc != 3):
                raise AssertionError(
                    f"ssd_scan B={B} S={S} H={H} P={P} N={N} B/C {dtype}: "
                    f"{tc} of 3 calls on the tensor-core route")
            for what, got, want in (("y", y, want_y), ("state", state, want_s),
                                    ("y given", y1, want_y),
                                    ("state given", s1, want_s),
                                    ("y0", y0, zero_y), ("state0", st0, zero_s)):
                err, rel = rel_gap(got, want)
                if not rel <= SSD_REL:
                    raise AssertionError(
                        f"ssd_scan B={B} S={S} H={H} P={P} N={N} decay "
                        f"{decay} B/C {dtype} {what}: kernel disagrees with "
                        f"plain version (max abs err {err}, relative {rel}, "
                        f"limit {SSD_REL})")
                a, b = errs.get(key, (0.0, 0.0))
                errs[key] = (max(a, err), max(b, rel))
    log(f"parity ok: {2 * len(cases)} ssd_scan cases (each from a state in "
        f"place, from a given state and from zeros; every N in 4-64 and P "
        f"in 8-64; N = P = 64 with bf16 B/C from S 64 on the tensor-core "
        f"route, by its sub-count; a slow decay across its segments), "
        f"limit max|d| <= {SSD_REL} x max(1, max|plain|); (max abs err, max "
        f"relative) by B/C dtype {errs}")
    return errs


def greedy_aligned(model, params, prompts, new: int, max_len: int):
    """Greedy tokens of an aligned batch through the model's API: prefill
    the (B, S) prompts, token 1 from the last hidden row, then one decode
    step at one position for every further token.  Returns the (B, new)
    tokens on the host and the seconds of the prefill (with its first
    token) and of the decode steps, each ended by a synchronize."""
    dev = prompts.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    state, hidden = model.prefill(params, prompts, max_len)
    tok = model.lm_head(params, hidden[:, -1:]).argmax(-1)       # (B, 1)
    sync()
    t1 = time.perf_counter()
    out = [tok]
    for step in range(new - 1):
        logits = model.decode_step(params, state, tok.int(),
                                   prompts.shape[1] + step)
        tok = logits.argmax(-1)
        out.append(tok)
    sync()
    return torch.cat(out, 1).cpu().numpy(), t1 - t0, time.perf_counter() - t1


def phase_small_zamba(dev) -> None:
    model = build_model(smoke_config("zamba2-7b"))
    cpu_params = model.init(0, device="cpu")
    card_params = tree_map(lambda t: t.to(dev), cpu_params)
    rng = np.random.default_rng(8)
    for rows, length in ((3, 9), (2, 40), (1, 5)):
        prompts = torch.tensor(rng.integers(0, model.cfg.vocab,
                                            (rows, length)).astype(np.int32))
        want = greedy_aligned(model, cpu_params, prompts, 8, length + 8)[0]
        got = greedy_aligned(model, card_params, prompts.to(dev), 8,
                             length + 8)[0]
        if not np.array_equal(got, want):
            raise AssertionError(f"SMOKE zamba2-7b, {rows} x {length}: card "
                                 f"{got.tolist()} != CPU {want.tolist()}")
    log("small input, zamba: card streams == CPU streams (SMOKE zamba2-7b, "
        "float32, aligned batches 3 x 9, 2 x 40, 1 x 5, 8 new tokens each)")


def zamba_norms(cfg) -> tuple[int, int, int]:
    """B2's launches a zamba2 step: the first Mamba layer's norm alone;
    every other Mamba layer's, each shared block's two and the final norm
    with their residual adds; each Mamba layer's gated output norm."""
    segments = cfg.n_layers // cfg.shared_attn_every
    return 1, cfg.n_layers + 2 * segments, cfg.n_layers


def phase_main_zamba(dev):
    """Full-width zamba2-7b through ``HybridLM``, counts from 0: 4 x 1000
    prompts greedy to 32 tokens, through the SSD kernel (81 launches a
    prefill or decode step) and RMSNorm only; then every layer's SSD call
    of a second prefill held against the plain version."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("zamba2-7b")
    model = build_model(cfg)
    ops.reset_counts()
    t0 = time.perf_counter()
    params = model.init(0, device=dev)
    prompts = torch.tensor(np.random.default_rng(9).integers(
        0, cfg.vocab, (ZAMBA_ROWS, ZAMBA_PROMPT)).astype(np.int32), device=dev)
    toks, t_prefill, t_decode = greedy_aligned(model, params, prompts,
                                               ZAMBA_NEW, ZAMBA_MAX_LEN)
    wall = time.perf_counter() - t0
    counts = {k: (c.kernel, c.plain) for k, c in ops.COUNTS.items()}
    peak = torch.cuda.max_memory_allocated()
    if toks.shape != (ZAMBA_ROWS, ZAMBA_NEW) or not (
            (toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"main-zamba: tokens {toks.tolist()}")
    steps = 1 + (ZAMBA_NEW - 1)                # the prefill and decode steps
    # the prefill's calls (S 1000) on the tensor-core route, the decode
    # steps' (S 1) on the CUDA-core one
    want = {"ssd_scan": cfg.n_layers * steps, "ssd_scan_tc": cfg.n_layers}
    for name, (kernel, plain) in counts.items():
        if plain or (name in want and kernel != want[name]) or (
                name not in ("ssd_scan", "ssd_scan_tc", "rmsnorm",
                             "rmsnorm_add", "rmsnorm_gated") and kernel):
            raise AssertionError(f"main-zamba: launches {counts}; want "
                                 f"{want}, B2, no other kernel and no plain "
                                 "version")
    check_norm_counts("main-zamba", counts, steps, zamba_norms(cfg))
    gaps, scales = ssd_layer_gaps(model, params, prompts)
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    log(f"main-zamba: zamba2-7b {cfg.n_layers} Mamba-2 layers + "
        f"{cfg.n_layers // cfg.shared_attn_every} shared blocks {cfg.dtype}, {ZAMBA_ROWS} prompts of {ZAMBA_PROMPT} tokens "
        f"(max_len {ZAMBA_MAX_LEN}), {toks.size} tokens; prefill "
        f"{t_prefill * 1e3:.2f} ms (with the first token), "
        f"{ZAMBA_NEW - 1} decode steps {t_decode * 1e3:.2f} ms = "
        f"{ZAMBA_ROWS * (ZAMBA_NEW - 1) / t_decode:.1f} tok/s; wall "
        f"{wall:.2f}s (init included); {weights} B of weights, "
        f"max_memory_allocated={peak} B; launches {counts} ({cfg.n_layers} "
        f"x {steps} prefill and decode steps: {counts['ssd_scan_tc'][0]} "
        f"prefill calls on the tensor-core route, "
        f"{counts['ssd_scan'][0] - counts['ssd_scan_tc'][0]} decode calls on "
        f"the CUDA-core one)")
    log("main-zamba, the SSD calls of a second prefill on the same prompts: "
        "kernel vs plain version on the same inputs, max|d| / max|plain| "
        "of y and the final state by layer: "
        + " ".join(f"{g:.2e}" for g in gaps) + f" (layer 0 gated at {SSD_REL}); "
        f"max|y|, max|state| of the plain version: layer 0 {scales[0][0]:.3e}, "
        f"{scales[0][1]:.3e}; over the layers {max(a for a, _ in scales):.3e}, "
        f"{max(b for _, b in scales):.3e}")
    return ({k: counts[k][0] for k in ("ssd_scan", "ssd_scan_tc", "rmsnorm",
                                       "rmsnorm_add", "rmsnorm_gated")},
            model, params)


def ssd_layer_gaps(model, params, prompts):
    """Per-layer max|d| / max|plain| between the SSD kernel and its plain
    version on each Mamba layer's own inputs in a prefill of ``prompts``
    (the larger of y's and the final state's; no floor at 1: at random
    init the SSD values are far below 1), and per layer the largest |y|
    and |state| of the plain version; raises if layer 0's gap exceeds
    SSD_REL."""
    gaps, scales = [], []
    launch = ops.ssd_scan

    def compare(xdt, la, bm, cm, state0=None, *, out_state=None):
        s0 = None if state0 is None else state0.clone()
        y, st = launch(xdt, la, bm, cm, state0, out_state=out_state)
        py, ps = ref.ssd_scan(xdt, la, bm, cm, s0)
        scale = (py.abs().max().item(), ps.abs().max().item())
        gaps.append(max(rel_gap(y, py)[0] / max(scale[0], 1e-30),
                        rel_gap(st, ps)[0] / max(scale[1], 1e-30)))
        scales.append(scale)
        return y, st

    ops.ssd_scan = compare                     # the model's calls, compared
    try:
        model.prefill(params, prompts, ZAMBA_MAX_LEN)
    finally:
        ops.ssd_scan = launch
    gc.collect()
    torch.cuda.empty_cache()
    if not gaps[0] <= SSD_REL:
        raise AssertionError(f"main-zamba: layer-0 SSD call of the prefill is "
                             f"{gaps[0]} (relative) from the plain version's, "
                             f"limit {SSD_REL}")
    return gaps, scales


def ssd_chunked(xdt, la, bm, cm, state, chunk: int = 256):
    """Composite yardstick, timed only: the reference's chunked form
    (``repro/models/mamba2.py:_ssd_chunked``, which halves its chunk until
    it divides S: 8 at S 1000) in torch, float32, from xdt and la."""
    B, S, H, P = xdt.shape
    Q = min(chunk, S)
    while S % Q:
        Q //= 2
    nc = S // Q

    def chunks(t):                              # (B, S, ...) -> (nc, B, Q, ...)
        return t.float().reshape(B, nc, Q, *t.shape[2:]).transpose(0, 1)

    xc, lc, bc, cc = chunks(xdt), chunks(la), chunks(bm), chunks(cm)
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=xdt.device))
    ys = []
    for c in range(nc):
        cs = torch.cumsum(lc[c], dim=1)                          # (B, Q, H)
        total = cs[:, -1:]
        G = torch.einsum("bqn,bkn->bqk", cc[c], bc[c])
        dec = torch.exp(cs[:, :, None, :] - cs[:, None, :, :])    # (B,Q,K,H)
        M = G[..., None] * torch.where(mask[None, :, :, None], dec, 0.0)
        y = torch.einsum("bqkh,bkhp->bqhp", M, xc[c])
        ys.append(y + torch.einsum("bqn,bhnp,bqh->bqhp", cc[c], state,
                                   torch.exp(cs)))
        wj = torch.exp(total - cs)
        state = state * torch.exp(total).transpose(1, 2)[..., None] \
            + torch.einsum("bqn,bqh,bqhp->bhnp", bc[c], wj, xc[c])
    return torch.stack(ys, 1).reshape(B, S, H, P), state


def ssd_cost(B, S, H, P, N, bc_bytes) -> tuple[int, int]:
    """(bytes, operations) of one SSD call, counted from the function and
    not from the kernel's tiling.  Bytes: xdt and y float32, la, B and C
    read once in their dtype, the state read and written.  Operations: the
    chunked dual form at the chunk length q (the last chunk ragged) that
    needs the fewest, a multiply and an add each: C.B^T once per batch row
    (B and C are one group shared by all heads), N for each of a chunk's
    q(q+1)/2 visible pairs; for each head, P for each visible pair (the
    decayed product with xdt), 4 N P a step (C.S and the state update) and
    N P a chunk (the state's decay)."""
    nbytes = (2 * B * S * H * P * 4 + B * S * H * 4 + 2 * B * S * N * bc_bytes
              + 2 * B * H * N * P * 4)

    def chunk_ops(q):
        return q * (q + 1) * (N + H * P) + H * (4 * q + 1) * N * P if q else 0

    nops = B * min((S // q) * chunk_ops(q) + chunk_ops(S % q)
                   for q in range(1, S + 1))
    return nbytes, nops


def phase_timing_ssd(dev) -> dict:
    """The SSD kernel, its plain version and the composite yardstick at the
    main-zamba prefill shape (B 4, S 1000, H 112, N = P = 64, bf16 B/C),
    and kernel and plain at the decode shape (B 4, S 1), one state per
    layer (81 states: more than the 50 MB L2), as device time."""
    cfg = get_config("zamba2-7b")
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    B, S = ZAMBA_ROWS, ZAMBA_PROMPT
    rng = np.random.default_rng(10)
    xdt, la, bm, cm, s0 = ssd_case(rng, dev, torch.bfloat16, B, S, H, P, N)
    t = {"kernel": device_ms([lambda: ops.ssd_scan(xdt, la, bm, cm, s0)] * 4),
         "plain": device_ms([lambda: ref.ssd_scan(xdt, la, bm, cm, s0)],
                            reps=3),
         "composite": device_ms([lambda: ssd_chunked(xdt, la, bm, cm, s0)],
                                reps=5)}
    eager = time_ms(lambda: ops.ssd_scan(xdt, la, bm, cm, s0))
    _, comp_gap = rel_gap(ssd_chunked(xdt, la, bm, cm, s0)[0],
                          ref.ssd_scan(xdt, la, bm, cm, s0)[0])
    cost = ssd_cost(B, S, H, P, N, 2)
    b_ms, b_by = bound(*cost, "tf32")             # its route: tensor cores
    f32_ms, f32_by = bound(*cost, torch.float32)  # the CUDA-core route's
    shape = f"prefill B={B} S={S} H={H} P={P} N={N} B/C bf16"
    log(f"timing ssd_scan [{shape}, tensor-core route]: device kernel "
        f"{t['kernel']:.5f} ms (2 launches), plain {t['plain']:.5f} ms, "
        f"composite (the reference's chunked form in torch) "
        f"{t['composite']:.5f} ms (its y {comp_gap:.2e} relative from the "
        f"plain version's), bound {b_ms:.6f} ms ({b_by}, operations at the "
        f"TF32 peak; at the float32 CUDA-core peak {f32_ms:.6f} ms, "
        f"{f32_by}); host-issued kernel {eager:.5f} ms")
    layers = [ssd_case(rng, dev, torch.bfloat16, B, 1, H, P, N)
              for _ in range(cfg.n_layers)]
    d = {"kernel": device_ms([lambda a=a: ops.ssd_scan(*a[:4], a[4],
                                                       out_state=a[4])
                              for a in layers]),
         "plain": device_ms([lambda a=a: ref.ssd_scan(*a[:4], a[4], a[4])
                             for a in layers])}
    db_ms, db_by = bound(*ssd_cost(B, 1, H, P, N, 2), torch.float32)
    log(f"timing ssd_scan [decode B={B} S=1 H={H} P={P} N={N}, state in "
        f"place]: device kernel {d['kernel']:.5f} ms, plain "
        f"{d['plain']:.5f} ms, bound {db_ms:.6f} ms ({db_by})")
    return dict(ms=t["kernel"], plain_ms=t["plain"], library_ms=None,
                composite_ms=t["composite"], bound_ms=b_ms, bound_by=b_by,
                bound_f32_ms=f32_ms, shape=shape, decode_ms=d["kernel"],
                decode_plain_ms=d["plain"], decode_bound_ms=db_ms)


def phase_step_zamba(model, params, times) -> None:
    """One 4-row zamba decode step and one 4 x 1000 prefill, host-issued
    and as device time, with the SSD kernel's and B2's shares."""
    cfg, dev = model.cfg, torch.device("cuda")
    rng = np.random.default_rng(11)
    prompts = torch.tensor(rng.integers(0, cfg.vocab, (ZAMBA_ROWS,
                                                       ZAMBA_PROMPT))
                           .astype(np.int32), device=dev)
    state, _ = model.prefill(params, prompts, ZAMBA_MAX_LEN)
    toks = torch.tensor(rng.integers(0, cfg.vocab, (ZAMBA_ROWS, 1))
                        .astype(np.int32), device=dev)
    alone, add, gated = zamba_norms(cfg)
    d, di = cfg.d_model, cfg.d_inner
    for name, fn, rows in (
            (f"zamba decode step ({ZAMBA_ROWS} rows at position "
             f"{ZAMBA_PROMPT})",
             lambda: model.decode_step(params, state, toks, ZAMBA_PROMPT),
             ZAMBA_ROWS),
            (f"zamba prefill ({ZAMBA_ROWS} x {ZAMBA_PROMPT})",
             lambda: model.prefill(params, prompts, ZAMBA_MAX_LEN),
             ZAMBA_ROWS * ZAMBA_PROMPT)):
        host = time_ms(fn, iters=5, warmup=2)
        devt = device_ms([fn], reps=5)
        norms = step_norms_ms(times, (alone, add, gated), rows, d, di)
        log(f"{name}: host-issued {host:.3f} ms, device {devt:.3f} ms "
            f"(card idle {max(0.0, 1 - devt / host):.1%} of the host-issued "
            f"time); B2's {alone} rmsnorm + {add - 1} add_rmsnorm + 1 "
            f"final_rmsnorm + {gated} gated_rmsnorm launches at their device "
            f"times = {norms:.4f} ms")
    ssd = times["ssd_scan"]
    log(f"zamba: {cfg.n_layers} ssd_scan launches at their device times = "
        f"{cfg.n_layers * ssd['decode_ms']:.3f} ms a decode step, "
        f"{cfg.n_layers * ssd['ms']:.3f} ms a prefill")


# -- speculative decode, seeded sampling and open-loop traffic ---------------

def spec_stream_gate(label, eng, ref_streams, margins=None) -> list[str]:
    """Each spec-on stream against its spec-off twin, one line a request:
    all equal, or the first divergence.  With ``margins`` (rid -> the
    spec-off run's top-2 logit margin of each token, in stream order) it
    is a gate: a divergence fails, with the spec-off margin there."""
    lines = []
    for r in sorted(eng.finished, key=lambda r: r.rid):
        got, want = r.output, ref_streams[r.rid]
        i = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                 None)
        if i is None and len(got) == len(want):
            lines.append(f"{r.rid}: all {len(got)} equal")
            continue
        i = min(len(got), len(want)) if i is None else i
        if margins is not None:
            ms = margins[r.rid]
            m = f"{ms[i]:.4f}" if i < len(ms) else "none (past its end)"
            raise AssertionError(
                f"{label} request {r.rid}: leaves the spec-off stream at "
                f"token {i}; the spec-off top-2 margin there is {m}")
        lines.append(f"{r.rid}: first divergence at token {i}")
    return lines


class MarginSampler:
    """A greedy per-request sampler (the engine's default: the argmax over
    the true vocab) that records the top-2 logit margin of each token it
    picks, in stream order."""

    def __init__(self, vocab: int):
        self.vocab, self.margins = vocab, []

    def __call__(self, key, logits):
        top = logits[..., :self.vocab].float().topk(2, dim=-1).values
        self.margins.append((top[..., 0] - top[..., 1]).item())
        return SM.greedy(logits, true_vocab=self.vocab)


def verify_windows(eng, rng):
    """Inputs of a verify forward on ``eng``'s pool: 4 slots on disjoint
    32-page tables at lengths 276-310, and for each width of
    VERIFY_WIDTHS (tokens (B, W), write pages, write offsets); tensors on
    the engine's device: (tables, lengths, {W: window})."""
    B, P = eng.max_slots, eng.sched.pages_per_slot
    lens = np.array([300, 288, 310, 276][:B], np.int32)
    tables = rng.permutation(eng.pool.num_pages)[:B * P].reshape(B, P) \
        .astype(np.int32)

    def t(a):
        return torch.tensor(np.ascontiguousarray(a), device=eng.device)

    windows = {}
    for W in VERIFY_WIDTHS:
        toks = rng.integers(0, eng.model.cfg.vocab, (B, W)).astype(np.int32)
        pos = lens[:, None] + np.arange(W)
        windows[W] = (t(toks), t(np.take_along_axis(tables, pos // PS, 1)),
                      t(pos % PS))
    return t(tables), t(lens), windows


def written_kv_gap(a, b, pages, offs, quant: bool) -> dict:
    """How the K/V that two calls wrote for one position a slot (at
    ``pages``, ``offs``) differ, by layer: with int8 pages the codes that
    differ, the largest code step and the largest relative scale gap; with
    float pages the largest |d|."""
    p, o = pages.long(), offs.long()
    out = {}
    for name in ("k", "v"):
        x, y = a[name][:, p, o], b[name][:, p, o]       # (L, B, Hkv, D)
        if quant:
            d = (x.int() - y.int()).abs().flatten(1)
            sx, sy = (t[name + "_scale"][:, p, o].flatten(1) for t in (a, b))
            rel = ((sx - sy).abs() / sy.abs().clamp_min(1e-30)).amax(1)
            out[name] = {"codes_differing": (d > 0).sum(1).tolist(),
                         "of": d.shape[1], "max_step": d.amax(1).tolist(),
                         "scale_rel_gap": rel.tolist()}
        else:
            out[name] = {"max_abs": (x.float() - y.float()).abs()
                         .flatten(1).amax(1).tolist()}
    return out


def verify_call_gaps(eng, limit) -> dict:
    """Position 0 of a verify window (W 3 and 5) against a decode step of
    the same tokens on the same pages (each call on its own copy of the
    engine's storage, :func:`verify_windows`), by width: max |d logit|
    over the true vocab, gated at ``limit`` (None: printed only); whether
    the argmax agrees; the K/V each call wrote for position 0
    (:func:`written_kv_gap`); and, when gated, the gap of a window off by
    one position (lengths + 1: its queries one RoPE position late, one
    stale key admitted), which must exceed ``limit``."""
    model, params, V = eng.model, eng.params, eng.model.cfg.vocab
    kw = {} if eng.kv_quant is None else {"quant": eng.kv_quant}
    tables, lens, windows = verify_windows(eng, np.random.default_rng(3))

    def call(step, lengths, *window):
        storage = {k: v.clone() for k, v in eng.pool.storage.items()}
        logits = step(params, storage, tables, lengths, *window, **kw)
        return logits[:, 0, :V], storage

    out = {}
    for W, (toks, wp, wo) in windows.items():
        dec, dst = call(model.paged_decode_step, lens, toks[:, :1],
                        wp[:, 0], wo[:, 0])
        ver, vst = call(model.paged_verify, lens, toks, wp, wo)
        gap = (ver - dec).abs().max().item()
        out[W] = {"gap": gap,
                  "argmax_agrees": bool((ver.argmax(-1)
                                         == dec.argmax(-1)).all()),
                  "written_kv": written_kv_gap(dst, vst, wp[:, 0], wo[:, 0],
                                               eng.kv_quant is not None)}
        del dst, vst
        if limit is None:
            continue
        bad, _ = call(model.paged_verify, lens + 1, toks, wp, wo)
        out[W]["off_by_one_gap"] = bad_gap = (bad - dec).abs().max().item()
        if not gap <= limit:
            raise AssertionError(f"verify W={W} position 0 vs decode: max "
                                 f"|d logit| {gap} > {limit}; {out[W]}")
        if not bad_gap > limit:
            raise AssertionError(f"verify W={W}: a window off by one "
                                 f"position gives max |d logit| {bad_gap} "
                                 f"<= the limit {limit}")
    return out


def phase_main_spec(label, extra, kernels, attn, ref_streams):
    """main with the self-2 drafter (``extra`` adds the KV policy): every
    request finishes, drafts are proposed, the drafter's flash attention
    runs on the tensor cores (2 launches a drafted token), the verify
    ticks are of widths 3 and 5 only, B1 (all split) and B2 launch exactly
    as many times as the ticks, chunks and drafter forwards need, no plain
    version runs; then the stream and per-call gates.  Returns the launch
    counts, B1's verify calls by width (a call a layer of each verify tick
    of that width) and the engine."""
    eng, counts, wall, peak = serve_main(list(extra) + SPEC_ARGS)
    check_served(eng, label, counts, kernels + SPEC_KERNELS)
    check_split(label, counts, attn, eng.sched.pages_per_slot)
    s, cfg = eng.stats, eng.model.cfg
    L, steps = cfg.n_layers, s["ticks"] + s["chunk_prefills"]
    fa = counts["flash_attention"][0]
    if s["draft_proposed"] <= 0 or fa != counts["flash_attention_tc"][0] \
            or fa % 2:
        raise AssertionError(f"{label}: {s['draft_proposed']} drafts, "
                             f"{fa} flash_attention launches "
                             f"({counts['flash_attention_tc'][0]} on the "
                             "tensor cores); want drafts and 2 tensor-core "
                             "launches a drafted token")
    forwards = fa // 2                  # 2 drafter layers a drafted token
    ticks_by_width = dict(sorted(s["verify_widths"].items()))
    widths = {W: L * n for W, n in ticks_by_width.items()}
    verify = sum(widths.values())
    if (not widths or set(widths) - set(VERIFY_WIDTHS)
            or verify > L * s["ticks"] or counts[attn][0] != L * steps):
        raise AssertionError(f"{label}: {attn} {counts[attn][0]} launches "
                             f"for {steps} ticks and chunks, verify ticks "
                             f"by width {ticks_by_width}")
    alone = (counts["rmsnorm"][0] - counts["rmsnorm_add"][0]
             - counts["rmsnorm_gated"][0])
    want = (steps + forwards, 2 * L * steps + 4 * forwards)
    if (alone, counts["rmsnorm_add"][0]) != want:
        raise AssertionError(f"{label}: B2 (standalone, add) launches "
                             f"{(alone, counts['rmsnorm_add'][0])}, want "
                             f"{want} ({steps} ticks and chunks, {forwards} "
                             "2-layer drafter forwards)")
    lines = spec_stream_gate(label, eng, ref_streams)
    gaps = verify_call_gaps(eng, limit=None)
    toks = sum(len(r.output) for r in eng.finished)
    log(f"{label}: self-2 drafter, k 4: proposed={s['draft_proposed']} "
        f"accepted={s['draft_accepted']} acceptance_rate="
        f"{s['acceptance_rate']:.4f}, {verify // L} verify ticks of "
        f"{s['ticks']} ticks, {toks} tokens, {toks / wall:.1f} tok/s wall "
        f"(init included: {wall:.2f}s), {served_rate(eng):.2f} requests/s; "
        f"B1 verify calls by width {widths} ({L} layers x the engine's "
        f"verify ticks by width {ticks_by_width}); B3 launches from the drafter "
        f"{fa} ({forwards} forwards); max_memory_allocated={peak} B; "
        f"launches {counts}")
    log(f"{label}, depth {L} (not gated: chaotic at random init): verify "
        f"position 0 vs decode by width {gaps}; streams against spec-off: "
        f"{'; '.join(lines)}")
    phase_step_spec(eng, label)
    spec_gates(label, eng)
    return {k: v[0] for k, v in counts.items()}, widths, eng


def phase_step_spec(eng, label) -> None:
    """A verify tick's two parts, host-issued and as device time: the
    verify forward over 4 slots at W 3 and 5 (:func:`verify_windows`), and
    one self-2 drafter forward at bucket 512 (a tick runs up to 4 a slot),
    with the card's idle share."""
    model, params = eng.model, eng.params
    kw = {} if eng.kv_quant is None else {"quant": eng.kv_quant}
    rng = np.random.default_rng(4)
    tables, lens, windows = verify_windows(eng, rng)
    fns = {f"verify forward (4 slots, W {W})": functools.partial(
        model.paged_verify, params, eng.pool.storage, tables, lens, *window,
        **kw) for W, window in windows.items()}
    drafter = eng.drafter
    buf = torch.tensor(rng.integers(0, model.cfg.vocab, (1, 512))
                       .astype(np.int32), device=eng.device)
    fns["self-2 drafter forward (bucket 512)"] = \
        lambda: drafter._next_logits(buf, 300)
    for name, fn in fns.items():
        host = time_ms(fn, iters=10, warmup=2)
        devt = device_ms([fn], reps=10)
        log(f"{label} {name}: host-issued {host:.3f} ms, device {devt:.3f} "
            f"ms (card idle {max(0.0, 1 - devt / host):.1%} of the "
            "host-issued time)")


def spec_gates(label, eng) -> None:
    """The stream and per-call gates on ``eng``'s weights cut to their
    first GATE_DEPTH layers (full widths, ``eng``'s KV policy, main's
    prompts and engine shape): spec-off streams with their top-2 margins
    (:class:`MarginSampler`), then spec-on with the self-1 drafter (drafts
    mostly rejected) and the self-2 one (the whole cut model: every draft
    accepted, 5 tokens a verify tick), each stream equal to its spec-off
    twin; then the per-call gate on the spec-off engine's pages."""
    args = launch_serve.parse_args(MAIN_ARGS)
    cfg = eng.model.cfg.replace(n_layers=GATE_DEPTH)
    model = build_model(cfg)
    params = dict(eng.params, blocks=tree_map(lambda a: a[:GATE_DEPTH],
                                              eng.params["blocks"]))
    prompts = launch_serve.make_prompts(args, cfg.vocab)

    def run(samplers=None, **kw):
        e = ServeEngine(model, params, max_slots=args.slots,
                        max_len=args.max_len, page_size=PS,
                        prefill_chunk=args.prefill_chunk,
                        kv_quant=eng.stats["kv_quant"], device=eng.device,
                        **kw)
        rids = [e.submit(p, max_new_tokens=args.max_new,
                         sampler=None if samplers is None else samplers[i])
                for i, p in enumerate(prompts)]
        e.run_until_drained()
        if any(r.error is not None for r in e.finished):
            raise AssertionError(f"{label} gates: a request failed")
        return e, rids

    samplers = [MarginSampler(cfg.vocab) for _ in prompts]
    off, rids = run(samplers)
    ref_streams = {r.rid: r.output for r in off.finished}
    margins = {rid: smp.margins for rid, smp in zip(rids, samplers)}
    if off.stats["preemptions"] or any(
            len(margins[rid]) != len(ref_streams[rid]) for rid in rids):
        raise AssertionError(f"{label} gates: spec-off margins not one a "
                             f"token ({off.stats['preemptions']} "
                             "preemptions)")
    low = min((m, rid, i) for rid, ms in margins.items()
              for i, m in enumerate(ms))
    for drafter in ("self-1", "self-2"):
        on, _ = run(spec_decode=drafter, spec_k=4)
        lines = spec_stream_gate(f"{label} depth {GATE_DEPTH} {drafter}",
                                 on, ref_streams, margins)
        s = on.stats
        log(f"{label} stream gate, depth {GATE_DEPTH}, {drafter} drafter: "
            f"proposed={s['draft_proposed']} accepted={s['draft_accepted']}"
            f", ticks {s['ticks']} (spec-off {off.stats['ticks']}), verify "
            f"ticks by width {dict(sorted(s['verify_widths'].items()))}; "
            f"against spec-off (must be equal; first divergence: none): "
            f"{'; '.join(lines)}")
    log(f"{label} stream gate, depth {GATE_DEPTH}: the spec-off run's "
        f"smallest top-2 margin {low[0]:.4f} (request {low[1]}, token "
        f"{low[2]})")
    call_limit = VERIFY_LOGIT_TOL[eng.stats["kv_quant"]]
    gaps = verify_call_gaps(off, call_limit)
    log(f"{label} per-call gate, depth {GATE_DEPTH}: verify position 0 vs "
        f"decode (limit {call_limit}) by width {gaps}")


def phase_main_sampled(dev) -> None:
    """Seeded sampling at full width: main's 8 requests, each seeded, with
    top-k, top-p and temperature heads cycled, served twice; then the same
    prompts seeded through rejection-sampled speculation (self-2,
    spec_temperature 0.8), twice: each pair's streams identical.  Then the
    threefry bits on the card against the CPU bit for bit, a temperature
    histogram against softmax, and the host-issued time of one seeded draw
    over the full vocab."""
    args = launch_serve.parse_args(MAIN_ARGS)
    cfg = get_config("qwen2-7b")
    model = build_model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    params = model.init(0, device=dev)
    prompts = launch_serve.make_prompts(args, cfg.vocab)
    V = cfg.vocab
    heads = [functools.partial(SM.sample_top_k, k=40, temperature=SAMPLE_T,
                               true_vocab=V),
             functools.partial(SM.sample_top_p, p=0.9, temperature=SAMPLE_T,
                               true_vocab=V),
             functools.partial(SM.sample_temperature, temperature=SAMPLE_T,
                               true_vocab=V)]

    def run(**ekw):
        ops.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ServeEngine(model, params, max_slots=args.slots,
                         max_len=args.max_len, page_size=PS,
                         prefill_chunk=args.prefill_chunk, device=dev,
                         **ekw) as eng:
            for i, p in enumerate(prompts):
                eng.submit(p, max_new_tokens=args.max_new, seed=i,
                           sampler=None if ekw else heads[i % 3])
            done = eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if any(r.error is not None or len(r.output) != args.max_new
               or not all(0 <= t < V for t in r.output) for r in done):
            raise AssertionError(f"main-sampled {ekw}: bad requests")
        if any(c.plain for c in ops.COUNTS.values()):
            raise AssertionError("main-sampled: a plain version ran")
        return {r.rid: r.output for r in done}, eng.stats, wall

    spec = dict(spec_decode="self-2", spec_k=4, spec_temperature=SAMPLE_T)
    for what, ekw in (("top-k / top-p / temperature heads", {}),
                      ("rejection-sampled speculation", spec)):
        a, s, wall = run(**ekw)
        b, _, wall2 = run(**ekw)
        if a != b:
            raise AssertionError(f"main-sampled, {what}: two runs differ")
        toks = sum(map(len, a.values()))
        extra = (f", proposed={s['draft_proposed']} accepted="
                 f"{s['draft_accepted']}" if ekw else "")
        log(f"main-sampled, {what}: 8 seeded requests x 2 runs, streams "
            f"identical; {toks} tokens, {toks / wall:.1f} / "
            f"{toks / wall2:.1f} tok/s wall; ticks={s['ticks']}{extra}")
    for seed in (0, 7, 2**31 - 1):
        k = prng.PRNGKey(seed)
        for shape in ((V,), (4, V), (7,)):
            if not torch.equal(prng.bits(k, shape, device=dev).cpu(),
                               prng.bits(k, shape)):
                raise AssertionError(f"prng.bits {seed} {shape}: card != CPU")
    logits = torch.tensor(HIST_LOGITS, device=dev)
    draws = SM.sample_temperature(prng.PRNGKey(11), logits.expand(
        HIST_DRAWS, -1), temperature=SAMPLE_T)
    seen = torch.bincount(draws.long(), minlength=len(HIST_LOGITS)).double()
    want = torch.softmax(logits.double() / SAMPLE_T, -1) * HIST_DRAWS
    chi2 = float(((seen - want) ** 2 / want).sum())
    if not chi2 < CHI2_BOUND:
        raise AssertionError(f"sample_temperature histogram: chi-square "
                             f"{chi2} >= {CHI2_BOUND}")
    row = torch.randn(V, device=dev)
    host = time_ms(lambda: SM.sample_temperature(
        prng.fold_in(prng.PRNGKey(5), 3), row, temperature=SAMPLE_T).item(),
        iters=20, warmup=3)
    log(f"main-sampled: prng.bits on the card == CPU bit for bit (seeds 0, "
        f"7, 2**31-1; shapes ({V},), (4, {V}), (7,)); sample_temperature "
        f"histogram of {HIST_DRAWS} draws over {len(HIST_LOGITS)} logits at "
        f"T {SAMPLE_T}: chi-square {chi2:.3f} (bound {CHI2_BOUND}, p 0.001); "
        f"one seeded draw over {V} logits: {host:.3f} ms host-issued")
    del params


def phase_traffic(main_rate: float) -> None:
    """An open-loop run through the launcher: 16 Poisson arrivals at the
    stated rate on the wall clock; the report must be complete (every
    request measured, no errors, every percentile, throughput and
    goodput), the paged path's kernels must launch and no plain version
    run.  Nothing else of the report is gated."""
    args = launch_serve.parse_args(MAIN_ARGS + TRAFFIC_ARGS)
    gc.collect()
    torch.cuda.empty_cache()
    eng, cfg = launch_serve.build_engine(args)
    ops.reset_counts()
    torch.cuda.synchronize()
    res = launch_serve.run_traffic_demo(eng, cfg, args)
    rep = res["report"]
    counts = {k: (c.kernel, c.plain) for k, c in ops.COUNTS.items()}
    n = args.requests
    pct = [rep[m][q] for m in ("ttft", "itl", "e2e")
           for q in ("p50", "p95", "p99")]
    if (rep["n_requests"] != n or rep["n_measured"] != n or rep["n_errors"]
            or rep["tokens"] != n * args.max_new or None in pct
            or not rep["tok_per_s"] > 0
            or set(rep["goodput"]) != {"tok_per_s", "req_per_s",
                                       "slo_attainment"}):
        raise AssertionError(f"traffic: incomplete report {rep}")
    for name in PAGED_KERNELS:
        if counts[name][0] <= 0:
            raise AssertionError(f"traffic: {name} did not launch")
    if any(p for _, p in counts.values()):
        raise AssertionError(f"traffic: a plain version ran {counts}")
    g = rep["goodput"]
    log(f"traffic: qwen2-7b paged, {n} Poisson arrivals at {args.rate} "
        f"requests/s (main served {main_rate:.2f} requests/s closed-loop), "
        f"wall clock: TTFT p50 {rep['ttft']['p50']:.4f} s p99 "
        f"{rep['ttft']['p99']:.4f} s, ITL p50 {rep['itl']['p50']:.4f} s p99 "
        f"{rep['itl']['p99']:.4f} s, e2e p50 {rep['e2e']['p50']:.4f} s p99 "
        f"{rep['e2e']['p99']:.4f} s, {rep['tok_per_s']:.2f} tok/s over "
        f"{rep['span']:.3f} s, goodput {g['tok_per_s']:.2f} tok/s "
        f"(slo_attainment {g['slo_attainment']:.2f}, no SLO); launches "
        f"{counts}")


SOURCES = {
    "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:38"),
    "paged_attention_mq": ("src/repro_torch/csrc/paged_attention.cu",
                           "src/repro/kernels/paged_attention.py:171"),
    "paged_attention_mq_int8": (
        "src/repro_torch/csrc/paged_attention.cu",
        "src/repro/kernels/paged_attention.py:171 (k_scale/v_scale)"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:113"),
    "rwkv6_scan": ("src/repro_torch/csrc/rwkv6_scan.cu",
                   "src/repro/kernels/rwkv6_scan.py:82"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:99"),
}


# the CUDA kernels behind each wrapper that has more than one: its routes'
# kernels, in launch order
DEVICE_KERNELS = {
    "rwkv6_scan": ["rwkv6_chunk_state_kernel", "rwkv6_chunk_pass_kernel",
                   "rwkv6_chunk_out_kernel", "rwkv6_scan_kernel"],
    "ssd_scan": ["ssd_seg_state_kernel", "ssd_seg_out_kernel",
                 "ssd_scan_kernel"],
}


def ptxas_report(*names: str) -> list[str]:
    """ptxas's register, spill and shared-memory lines for the kernels
    whose mangled name holds every one of ``names``."""
    lines, cur = [], ""
    for line in build.build_log().splitlines():
        if "Compiling entry function" in line:
            cur = line.split("'")[1] if "'" in line else line
        elif all(n in cur for n in names) and ("registers" in line
                                               or "spill" in line):
            lines.append(f"{cur}: {line.split(':', 1)[-1].strip()}")
    return lines


def main() -> int:
    kind, smi = phase_device()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.library()
    log(f"build: kernels ready in {time.perf_counter() - t0:.1f}s "
        f"({', '.join(p.name for p in build.sources())})")
    # flash attention: the tensor-core route at D 64 and 128, the CUDA-core
    # route at every D; paged attention's split kernel (float and int8
    # pages) at 4 accumulator columns a lane, D 97-128, and the combine;
    # the wkv kernels: the CUDA-core one at K 64, the tensor-core route's
    # three; the SSD kernels: the CUDA-core one at N = P = 64, the
    # tensor-core route's two
    for line in (ptxas_report("flash_attention_tc_kernel")
                 + ptxas_report("flash_attention_kernel")
                 + ptxas_report("paged_attention_split_kernel", "Li4E")
                 + ptxas_report("paged_attention_combine_kernel")
                 + ptxas_report("rwkv6_scan_kernel", "ILi64E")
                 + ptxas_report("rwkv6_chunk_state_kernel")
                 + ptxas_report("rwkv6_chunk_pass_kernel")
                 + ptxas_report("rwkv6_chunk_out_kernel")
                 + ptxas_report("ssd_scan_kernel", "ILi64ELi64E")
                 + ptxas_report("ssd_seg_state_kernel")
                 + ptxas_report("ssd_seg_out_kernel")):
        log(f"ptxas {line}")
    lib = build.library()
    log("dynamic shared memory of the tensor-core routes: wkv launches 1 "
        f"and 3 {lib.rwkv6_scan_tc_smem(1)} / {lib.rwkv6_scan_tc_smem(3)} B, "
        f"SSD launches 1 and 2 {lib.ssd_scan_tc_smem(1)} / "
        f"{lib.ssd_scan_tc_smem(2)} B")
    errs = phase_parity(dev)
    rwkv_errs = phase_parity_rwkv(dev)
    errs["rwkv6_scan"] = max(e for e, _ in rwkv_errs.values())
    ssd_errs = phase_parity_ssd(dev)
    errs["ssd_scan"] = max(e for e, _ in ssd_errs.values())
    phase_small(dev)
    phase_small_rwkv(dev)
    phase_small_zamba(dev)
    launches, eng, bf16_peak = phase_main()
    main_rate = served_rate(eng)
    paged_launches = dict(launches)
    # read before the step phase writes into the pool's pages
    prompt = launch_serve.make_prompts(launch_serve.parse_args(MAIN_ARGS),
                                       eng.model.cfg.vocab)[0]
    ref_kv = layer0_kv(eng, prompt)
    ref_streams = {r.rid: r.output for r in eng.finished}
    times = phase_timing(dev)
    phase_step(eng, times)
    del eng                             # free the paged model's weights
    int8_launches, eng = phase_main_int8(ref_kv, ref_streams, prompt)
    int8_streams = {r.rid: r.output for r in eng.finished}
    phase_step(eng, times, "int8 KV: ")
    del eng
    eng = phase_main_int8w(bf16_peak, ref_streams)
    phase_step(eng, times, "int8 KV and weights: ")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    dense_launches, eng = phase_main_dense()
    phase_step_dense(eng, times)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    rwkv_launches, eng = phase_main_rwkv()
    launches.update(rwkv_launches)
    times["rwkv6_scan"] = phase_timing_rwkv(dev)
    phase_step_rwkv(eng, times["rwkv6_scan"])
    del eng                             # free the rwkv engine's weights
    gc.collect()
    torch.cuda.empty_cache()
    zamba_launches, model, params = phase_main_zamba(dev)
    launches.update({k: zamba_launches[k] for k in ("ssd_scan",
                                                    "ssd_scan_tc")})
    times["ssd_scan"] = phase_timing_ssd(dev)
    phase_step_zamba(model, params, times)
    del model, params
    # the paged path's request features: speculation (bf16 and int8
    # pages), seeded sampling, open-loop traffic
    spec_launches, widths, eng = phase_main_spec(
        "main-spec", (), PAGED_KERNELS, "paged_attention_mq", ref_streams)
    del eng
    _, int8_widths, eng = phase_main_spec(
        "main-spec-int8", ("--kv-quant", "int8"), INT8_KERNELS,
        "paged_attention_mq_int8", int8_streams)
    del eng
    phase_main_sampled(dev)
    phase_traffic(main_rate)
    times["paged_attention_mq"]["verify_launches"] = {
        f"W{W}": n for W, n in widths.items()}
    times["paged_attention_mq_int8"]["verify_launches"] = {
        f"W{W}": n for W, n in int8_widths.items()}
    times["flash_attention"]["drafter_launches"] = \
        spec_launches["flash_attention"]
    # each kernel's launches from the run of the path that carries it
    launches["flash_attention"] = dense_launches["flash_attention"]
    times["flash_attention"].update(
        {f"s2048_{k}": times["flash_attention S=2048"][k]
         for k in ("ms", "plain_ms", "library_ms", "bound_ms")})
    launches["paged_attention_mq_int8"] = \
        int8_launches["paged_attention_mq_int8"]
    # B2's launches (standalone, fused add, gated) in each run that has it
    times["rmsnorm"]["launches_by_run"] = {
        label: {"rmsnorm": c["rmsnorm"] - c["rmsnorm_add"] - c["rmsnorm_gated"],
                "add_rmsnorm": c["rmsnorm_add"],
                "gated_rmsnorm": c["rmsnorm_gated"]}
        for label, c in (("main", paged_launches), ("main-dense", dense_launches),
                         ("main-zamba", zamba_launches))}
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "parity": "pass",
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "timed_shape": t["shape"],
            **({"device_kernels": DEVICE_KERNELS[name],
                "tc_launches": launches[f"{name}_tc"]}
               if name in DEVICE_KERNELS else {}),
            **{k: t[k] for k in (
                "verify_ms", "verify_plain_ms", "verify_library_ms",
                "verify_bound_ms", "verify_bound_by", "verify_host_ms",
                "verify_shape", "verify_launches", "drafter_launches",
                "bound_f32_ms",
                "composite_ms", "decode_ms", "decode_plain_ms",
                "decode_bound_ms", "chunk_ms", "chunk_plain_ms",
                "chunk_library_ms", "chunk_bound_ms", "chunk_shape",
                "s2048_ms", "s2048_plain_ms", "s2048_library_ms",
                "s2048_bound_ms", "floor_ms", "floor_host_ms", "variants",
                "launches_by_run") if k in t}})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
