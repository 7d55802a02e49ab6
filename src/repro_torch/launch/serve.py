"""Serving launcher of the port: continuous-batching engine demo.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \\
        --requests 8 --max-new 32

runs the full-size model with random weights on the card through the
paged engine (``--kv-quant int8`` with int8 KV pages, ``--weight-quant
int8`` with int8 weights, quantized as they are drawn); ``--dense`` serves
through the dense per-slot path instead (whole-prompt prefills farmed over
``--prefill-workers`` threads);
``--arch rwkv6-3b`` serves rwkv6 (a recurrent state per slot, no paged
KV cache) on the dense path without ``--dense``; ``--arch zamba2-7b`` is
refused, as in the reference (zamba2 serves only as an aligned batch:
:class:`repro_torch.models.api.HybridLM`);
``--smoke --device cpu`` runs the small config on the CPU through the
kernels' plain versions.  ``--spec-decode ngram|self-K`` speculates up to
``--spec-k`` tokens a slot and verifies them in one batched forward (paged
path).  ``--traffic poisson|bursty`` drives the engine with a seeded
open-loop arrival process at ``--rate`` requests a clock unit instead of
submitting everything up front, and prints the metric report (TTFT, ITL,
e2e, goodput under ``--slo-ttft`` / ``--slo-e2e``); ``--clock virtual``
counts engine ticks (deterministic), ``--clock wall`` seconds;
``--metrics-out`` writes the report as JSON.  Prints the reference
launcher's summary lines plus each kernel's launch count.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.kernels import ops
from repro_torch.models.api import build_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.traffic import make_workload, run_traffic


def parse_args(argv=None):
    """The launcher's command line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--dense", action="store_true",
                    help="force the dense per-slot path (a family without "
                    "a paged KV cache, such as rwkv6, takes it by itself)")
    ap.add_argument("--prefill-workers", type=int, default=4,
                    help="threads of the dense path's prefill farm")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="pool size (default: dense-equivalent budget)")
    ap.add_argument("--prefill-chunk", type=int, default=64)
    ap.add_argument("--prefix-cache", choices=("on", "off"), default="on",
                    help="cross-request KV reuse: refcounted pages + radix "
                    "prefix index + copy-on-write")
    ap.add_argument("--shared-prefix", type=int, default=24, metavar="L",
                    help="prepend an L-token common prefix to every prompt "
                    "(a shared system prompt; 0 disables)")
    ap.add_argument("--kv-quant", choices=("int8", "off"), default="off",
                    help="store KV pages as int8 with per-(token, head) "
                    "scale leaves, dequantized inside attention")
    ap.add_argument("--weight-quant", choices=("int8", "off"), default="off",
                    help="store the weights as per-tensor int8, dequantized "
                    "where each is used (a layer's inside the layer loop)")
    ap.add_argument("--spec-decode", default="off", metavar="ngram|self-K|off",
                    help="speculative multi-token decode: a drafter proposes "
                    "tokens, one batched verify accepts the prefix the "
                    "target agrees with (paged families only; 'ngram' = "
                    "prompt-lookup, 'self-2' = first-2-layer self-draft)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="max draft tokens per verify window")
    ap.add_argument("--traffic", choices=("off", "poisson", "bursty"),
                    default="off",
                    help="drive the engine with an open-loop seeded arrival "
                    "process instead of submitting everything up front")
    ap.add_argument("--rate", type=float, default=0.5,
                    help="traffic arrival rate (requests per clock unit)")
    ap.add_argument("--clock", choices=("virtual", "wall"), default="virtual",
                    help="virtual: 1 tick = 1 time unit, fully "
                    "deterministic; wall: real seconds")
    ap.add_argument("--slo-ttft", type=float, default=None, metavar="T",
                    help="goodput SLO: time-to-first-token bound "
                    "(clock units)")
    ap.add_argument("--slo-e2e", type=float, default=None, metavar="T",
                    help="goodput SLO: end-to-end latency bound "
                    "(clock units)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the traffic metric report as JSON")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def make_prompts(args, vocab: int) -> list:
    """The seeded prompts: ``--shared-prefix`` common tokens, then 4-47 own
    tokens each."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, args.shared_prefix)
    return [np.concatenate([shared,
                            rng.integers(0, vocab, int(rng.integers(4, 48)))])
            for _ in range(args.requests)]


def run_traffic_demo(eng, cfg, args) -> dict:
    """Open-loop traffic run: seeded workload, event log, metric report
    (printed, and written to ``--metrics-out``); returns
    :func:`repro_torch.serve.traffic.run_traffic`'s result.  Closes the
    engine."""
    slo = {}
    if args.slo_ttft is not None:
        slo["ttft"] = args.slo_ttft
    if args.slo_e2e is not None:
        slo["e2e"] = args.slo_e2e
    # cap prompt bands so prefix + tail + generation fit in max_len
    hi = max(5, args.max_len - args.shared_prefix - args.max_new - 1)
    len_mix = ((3.0, 4, min(24, hi)), (1.0, min(32, hi), hi))
    wl = make_workload(kind=args.traffic, n_requests=args.requests,
                       rate=args.rate, vocab=cfg.vocab, seed=0,
                       max_new_tokens=args.max_new,
                       shared_prefix_len=args.shared_prefix, n_sessions=2,
                       len_mix=len_mix)
    t0 = time.perf_counter()
    res = run_traffic(eng, wl, clock=args.clock, slo=slo or None)
    dt = time.perf_counter() - t0
    eng.close()
    rep = res["report"]
    unit = "ticks" if args.clock == "virtual" else "s"
    print(f"[serve] traffic {args.traffic} rate={args.rate}: "
          f"{rep['n_measured']}/{rep['n_requests']} requests, "
          f"{rep['tokens']} tokens over {rep['span']:.1f} {unit} "
          f"({dt:.2f}s wall)")
    for name in ("ttft", "itl", "e2e"):
        p = rep[name]
        print(f"[serve] {name}: p50={p['p50']} p95={p['p95']} "
              f"p99={p['p99']} {unit} (n={p['n']})")
    g = rep["goodput"]
    per = "tick" if args.clock == "virtual" else "s"
    print(f"[serve] goodput: {g['tok_per_s']:.3f} tok/{per} "
          f"slo_attainment={g['slo_attainment']:.2f}")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump({"args": {"traffic": args.traffic, "rate": args.rate,
                                "clock": args.clock,
                                "requests": args.requests,
                                "max_new": args.max_new},
                       "wall_seconds": dt, "report": rep}, f, indent=2)
        print(f"[serve] metrics written to {args.metrics_out}")
    return res


def build_engine(args):
    """The model of ``args`` with seeded random weights, and the engine
    that serves it: ``(engine, config)``."""
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg)
    why = model.engine_refusal()
    if why:  # before init allocates the weights
        raise SystemExit(f"{args.arch}: the engine demo serves KV-cache and "
                         f"recurrent-slot families; {args.arch} is {why} "
                         f"({type(model).__name__}.prefill and decode_step)")
    params = model.init(0, device=args.device, weight_quant=args.weight_quant)
    eng = ServeEngine(model, params, max_slots=args.slots,
                      max_len=args.max_len, page_size=args.page_size,
                      num_pages=args.num_pages,
                      prefill_chunk=args.prefill_chunk,
                      prefix_cache=args.prefix_cache == "on",
                      prefill_workers=args.prefill_workers,
                      paged=False if args.dense else None,
                      kv_quant=args.kv_quant, weight_quant=args.weight_quant,
                      spec_decode=None if args.spec_decode == "off"
                      else args.spec_decode, spec_k=args.spec_k,
                      device=args.device)
    return eng, cfg


def main(argv=None):
    """Build the model, serve seeded random prompts (or a traffic run),
    print the summary; returns the engine."""
    args = parse_args(argv)
    eng, cfg = build_engine(args)
    ops.reset_counts()
    if eng.device.type == "cuda":   # the seeded init runs asynchronously
        torch.cuda.synchronize(eng.device)
    if args.traffic != "off":
        run_traffic_demo(eng, cfg, args)
        print_counts()
        return eng
    t0 = time.perf_counter()
    for prompt in make_prompts(args, cfg.vocab):
        eng.submit(prompt, max_new_tokens=args.max_new)
    done = eng.run_until_drained()
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done)
    ttfts = [r.first_token_at - r.submitted_at for r in done
             if r.first_token_at is not None]
    s = eng.stats
    mode = "dense" if not eng.paged else (
        f"paged(ps={eng.pool.page_size}, "
        f"hw={s['pages_high_water']}/{eng.pool.num_pages} pages, "
        f"prefix-cache {'on' if eng.prefix_cache else 'off'})")
    if eng.kv_quant is not None or eng.weight_quant:
        mode += (f" quant(kv={s['kv_quant']}, w={s['weight_quant']}, "
                 f"{s['kv_bytes_per_token']} KV B/tok)")
    if eng.drafter is not None:
        mode += f" spec={args.spec_decode}(k={eng.spec_k})"
    print(f"[serve] {len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s); ticks={s['ticks']} "
          f"chunks={s['chunk_prefills']} "
          f"preempt={s['preemptions']} [{mode}] "
          f"mean TTFT {np.mean(ttfts)*1e3:.0f}ms")
    if eng.paged:
        print(f"[serve] kv_bytes_per_token={s['kv_bytes_per_token']}")
        print(f"[serve] prefix cache: hits={s['prefix_hits']} "
              f"hit_tokens={s['prefix_hit_tokens']} "
              f"cow_copies={s['cow_copies']} evictions={s['evictions']} "
              f"cached_now={eng.pool.pages_cached} pages")
        if eng.drafter is not None:
            print(f"[serve] spec decode: proposed={s['draft_proposed']} "
                  f"accepted={s['draft_accepted']} "
                  f"acceptance_rate={s['acceptance_rate']:.2f}")
    print_counts()
    eng.close()
    return eng


def print_counts() -> None:
    """Each kernel's launches and plain-version calls since the reset."""
    print("[serve] kernels: " + " ".join(
        f"{name}: launches={c.kernel} plain={c.plain}"
        for name, c in ops.COUNTS.items()))


if __name__ == "__main__":
    main()
