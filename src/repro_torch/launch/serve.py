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
kernels' plain versions.  Prints the reference launcher's summary lines
plus each kernel's launch count.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.kernels import ops
from repro_torch.models.api import build_model
from repro_torch.serve.engine import ServeEngine


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


def main(argv=None):
    """Build the model, serve seeded random prompts, print the summary."""
    args = parse_args(argv)
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
                      device=args.device)

    ops.reset_counts()
    if eng.device.type == "cuda":   # the seeded init runs asynchronously
        torch.cuda.synchronize(eng.device)
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
    print("[serve] kernels: " + " ".join(
        f"{name}: launches={c.kernel} plain={c.plain}"
        for name, c in ops.COUNTS.items()))
    eng.close()
    return eng


if __name__ == "__main__":
    main()
