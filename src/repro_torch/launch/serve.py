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
``--metrics-out`` writes the report as JSON.  ``--disagg`` serves through
a prefill-only engine and a decode engine with a KV page handoff between
them (:class:`repro_torch.serve.disagg.DisaggServeEngine`, paged only),
their stages driven by ``--executor serial|thread``.  ``--arch
qwen3-moe-235b-a22b`` or ``arctic-480b`` serves an MoE model;
``--expert-placement N`` re-places its experts every N ticks from the
measured per-expert token counts, and the paged run prints a ``[serve]
moe:`` line (assignments routed and dropped, the rank imbalance, the
placements).  ``--arch llava-next-mistral-7b --image`` attaches one of
two alternating images to the requests (``--encoder-frac`` of them under
``--traffic``), ``--arch whisper-tiny --audio`` one of two clips to every
request, which then prints a ``[serve] cross-KV:`` line (encode chunks,
cross pages in use); neither goes through ``--disagg``, nor ``--audio``
through ``--dense``.  Prints the reference launcher's summary lines plus
each kernel's launch count.

``--mesh tp=N[,ep=M]`` serves tensor-parallel over a serving mesh of
``tp * ep`` ranks (:func:`parse_mesh`): the launcher runs its serve body on
that many ranks through :func:`repro_torch.core.comm.run_ranks` (NCCL, one
card a rank, on ``--device cuda``; gloo on ``--device cpu``), each rank
builds the same seeded weights and serves its shard, and rank 0 prints the
summary with the reference's `` tp=N ep=M`` mode tag.  Too few cards
raise, as ``run_ranks`` does; there is no gloo fallback on the card.  The
ranks meet through a file store in ``--store-dir``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
        --smoke --device cpu --mesh tp=2
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.core import comm as C
from repro_torch.kernels import ops
from repro_torch.models.api import build_model
from repro_torch.serve.disagg import DisaggServeEngine
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
    ap.add_argument("--expert-placement", type=int, default=0, metavar="N",
                    help="re-place experts every N ticks from measured "
                    "per-expert token counts (load_balance-driven, "
                    "hot-expert replication; 0 = off)")
    ap.add_argument("--disagg", action="store_true",
                    help="split serving into a prefill-only engine and a "
                    "decode engine with KV page handoff between them")
    ap.add_argument("--executor", choices=("serial", "thread"),
                    default="serial",
                    help="how the disagg stages run: deterministic serial "
                    "order or overlapped farm threads")
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
    ap.add_argument("--mesh", default=None, metavar="tp=N[,ep=M]",
                    help="serve tensor-parallel over N ranks ('model' "
                    "axis); add ep=M for a 2-D ('expert', 'model') mesh "
                    "partitioning whole MoE experts over M ranks (NCCL, "
                    "one card a rank, on cuda; gloo on cpu)")
    ap.add_argument("--store-dir", default="build/ranks",
                    help="where a mesh's ranks meet (a file store)")
    ap.add_argument("--image", action="store_true",
                    help="multimodal serving: attach precomputed image-patch "
                    "embeddings to a fraction of requests (VLM families; "
                    "the image prefix pages share through the prefix cache)")
    ap.add_argument("--audio", action="store_true",
                    help="multimodal serving: attach audio frames to every "
                    "request (enc-dec families; streaming chunked encode "
                    "into read-only cross-KV pages)")
    ap.add_argument("--encoder-frac", type=float, default=0.5,
                    help="fraction of requests carrying an image with "
                    "--image under --traffic (audio is always 1.0: enc-dec "
                    "needs a clip)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.disagg and args.dense:
        raise SystemExit("--disagg needs the paged KV engine; drop --dense")
    check_encoder_flags(args, arch_config(args))
    parse_mesh(args.mesh)           # a bad spec fails before any rank starts
    return args


def arch_config(args):
    """The config ``args`` name: ``--arch``, its SMOKE twin with
    ``--smoke``."""
    return smoke_config(args.arch) if args.smoke else get_config(args.arch)


def check_encoder_flags(args, cfg) -> None:
    """The reference launcher's refusals of ``--image`` / ``--audio``: each
    needs its family, and neither goes through ``--disagg`` (``--audio``
    not through ``--dense`` either)."""
    if args.image and cfg.family != "vlm":
        raise SystemExit(f"--image needs a VLM arch (family 'vlm'); "
                         f"{args.arch} is '{cfg.family}'")
    if args.audio and cfg.family != "audio":
        raise SystemExit(f"--audio needs an enc-dec arch (family 'audio'); "
                         f"{args.arch} is '{cfg.family}'")
    if args.audio and (args.disagg or args.dense):
        raise SystemExit("--audio serves monolithic and paged only (cross-KV "
                         "pages have no handoff or dense twin); drop "
                         "--disagg/--dense")
    if (args.image or args.audio) and args.disagg:
        raise SystemExit("--image/--audio are wired through the monolithic "
                         "engine; drop --disagg")


def encoder_workload_kwargs(cfg, args) -> dict:
    """``--image`` / ``--audio`` -> the multimodal band of
    :func:`repro_torch.serve.traffic.make_workload` (empty with both off,
    which keeps the text schedule as it was)."""
    shape = encoder_shape(cfg, args)
    if shape is None:
        return {}
    # an enc-dec model refuses a request without a clip: every one has one
    return dict(encoder="image" if args.image else "audio",
                encoder_shape=shape,
                encoder_frac=args.encoder_frac if args.image else 1.0,
                n_encoder_inputs=2)


def parse_mesh(spec):
    """``"tp=N[,ep=M]"`` -> the serving mesh's ``(shape, axis_names)``
    (None for no spec).  ``tp=N`` alone is the 1-D ``("model",)`` mesh;
    any spec naming ``ep`` is the 2-D ``("expert", "model")`` mesh of
    ep x tp ranks (``ep=M`` alone means tp=1), as the reference's."""
    if not spec:
        return None
    vals: dict[str, int] = {}
    for part in spec.split(","):
        key, _, val = part.partition("=")
        if key not in ("tp", "ep") or key in vals \
                or not val.isdigit() or int(val) < 1:
            raise SystemExit(
                f"--mesh expects tp=N[,ep=M] (each >= 1), got {spec!r}")
        vals[key] = int(val)
    tp, ep = vals.get("tp", 1), vals.get("ep")
    if ep is None:
        return (tp,), ("model",)
    return (ep, tp), ("expert", "model")


def encoder_shape(cfg, args):
    """The ``(n, d_model)`` payload of ``--image`` / ``--audio`` (None with
    both off)."""
    if args.image:
        return cfg.n_image_tokens, cfg.d_model
    if args.audio:
        return cfg.n_audio_frames, cfg.d_model
    return None


def make_requests(args, vocab: int, enc_shape=None) -> list:
    """The seeded requests, ``(prompt, encoder payload or None)`` each: the
    prompts are ``--shared-prefix`` common tokens, then 4-47 own tokens;
    with an ``enc_shape`` the requests alternate between two payloads of
    that shape (a repeated image shares its prefix pages, distinct ones
    never alias), drawn after the shared prefix as the reference draws
    them."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, args.shared_prefix)
    pool = [] if enc_shape is None else [
        rng.standard_normal(enc_shape).astype(np.float32) for _ in range(2)]
    out = []
    for i in range(args.requests):
        tail = rng.integers(0, vocab, int(rng.integers(4, 48)))
        out.append((np.concatenate([shared, tail]),
                    pool[i % 2] if pool else None))
    return out


def make_prompts(args, vocab: int) -> list:
    """The seeded text prompts of :func:`make_requests`."""
    return [p for p, _ in make_requests(args, vocab)]


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
    # cap prompt bands so prefix + tail + generation (and a VLM's image
    # pseudo-token prefix) fit in max_len
    enc_extra = cfg.n_image_tokens if args.image else 0
    hi = max(5, args.max_len - args.shared_prefix - args.max_new - 1
             - enc_extra)
    len_mix = ((3.0, 4, min(24, hi)), (1.0, min(32, hi), hi))
    wl = make_workload(kind=args.traffic, n_requests=args.requests,
                       rate=args.rate, vocab=cfg.vocab, seed=0,
                       max_new_tokens=args.max_new,
                       shared_prefix_len=args.shared_prefix, n_sessions=2,
                       len_mix=len_mix, **encoder_workload_kwargs(cfg, args))
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
    if args.metrics_out and (eng.mesh is None or eng.mesh.world.rank() == 0):
        with open(args.metrics_out, "w") as f:
            json.dump({"args": {"traffic": args.traffic, "rate": args.rate,
                                "clock": args.clock,
                                "requests": args.requests,
                                "max_new": args.max_new},
                       "wall_seconds": dt, "report": rep}, f, indent=2)
        print(f"[serve] metrics written to {args.metrics_out}")
    return res


def build_engine(args, mesh=None):
    """The model of ``args`` with seeded random weights, and the engine
    that serves it (this rank's, on a serving ``mesh``): ``(engine,
    config)``."""
    cfg = arch_config(args)
    model = build_model(cfg)
    why = model.engine_refusal()
    if why:  # before init allocates the weights
        raise SystemExit(f"{args.arch}: the engine demo serves KV-cache and "
                         f"recurrent-slot families; {args.arch} is {why} "
                         f"({type(model).__name__}.prefill and decode_step)")
    params = model.init(0, device=args.device, weight_quant=args.weight_quant)
    kw = dict(max_slots=args.slots, max_len=args.max_len,
              page_size=args.page_size, num_pages=args.num_pages,
              prefill_chunk=args.prefill_chunk,
              prefix_cache=args.prefix_cache == "on",
              kv_quant=args.kv_quant, weight_quant=args.weight_quant,
              spec_decode=None if args.spec_decode == "off"
              else args.spec_decode, spec_k=args.spec_k, device=args.device,
              placement_interval=args.expert_placement, mesh=mesh)
    if args.disagg:
        eng = DisaggServeEngine(model, params, executor=args.executor, **kw)
    else:
        eng = ServeEngine(model, params, prefill_workers=args.prefill_workers,
                          paged=False if args.dense else None, **kw)
    return eng, cfg


def main(argv=None):
    """Build the model, serve seeded random prompts (or a traffic run),
    print the summary; returns the engine.  With ``--mesh``, the serve body
    runs on the mesh's ranks and this returns each rank's
    :func:`serve_rank` result instead."""
    args = parse_args(argv)
    mesh = parse_mesh(args.mesh)
    if mesh is None:
        return serve(args)
    return C.run_ranks(serve_rank, (args,), world=math.prod(mesh[0]),
                       store_dir=args.store_dir, device=args.device,
                       timeout=3600)


def serve_rank(comm, args) -> dict:
    """One rank of a ``--mesh`` run: make the mesh, serve, and return the
    rank's streams and its mesh shape; only rank 0 prints."""
    mesh = C.make_mesh(*parse_mesh(args.mesh))
    quiet = contextlib.redirect_stdout(io.StringIO()) if comm.rank() \
        else contextlib.nullcontext()
    with quiet:
        eng = serve(args, mesh)
    return {"streams": {r.rid: list(r.output) for r in eng.finished},
            "tp": eng.tp if hasattr(eng, "tp") else eng.decoder.tp,
            "ep": eng.ep if hasattr(eng, "ep") else eng.decoder.ep}


def serve(args, mesh=None):
    """The serve body: build the engine (on ``mesh``, this rank's), serve,
    print the summary; returns the engine."""
    eng, cfg = build_engine(args, mesh)
    ops.reset_counts()
    if eng.device.type == "cuda":   # the seeded init runs asynchronously
        torch.cuda.synchronize(eng.device)
    if args.traffic != "off":
        run_traffic_demo(eng, cfg, args)
        print_counts()
        return eng
    t0 = time.perf_counter()
    for prompt, payload in make_requests(args, cfg.vocab,
                                         encoder_shape(cfg, args)):
        kw = {} if payload is None else {"encoder_input": payload}
        eng.submit(prompt, max_new_tokens=args.max_new, **kw)
    done = eng.run_until_drained()
    dt = time.perf_counter() - t0
    toks = sum(len(r.output) for r in done)
    if args.disagg:
        s = eng.stats
        print(f"[serve] disagg: {len(done)} requests, {toks} tokens in "
              f"{dt:.2f}s ({toks/dt:.1f} tok/s); "
              f"prefill ticks={s['prefill']['ticks']} "
              f"handoffs={s['prefill']['kv_handoffs']} | "
              f"decode ticks={s['decode']['ticks']} "
              f"injections={s['decode']['kv_injections']} "
              f"preempt={s['decode']['preemptions']} "
              f"[executor={args.executor}]")
        print_counts()
        eng.close()
        return eng
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
    if mesh is not None:
        mode += f" tp={eng.tp}" + (f" ep={eng.ep}" if eng.ep > 1 else "")
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
        if eng.cross_pool is not None:
            print(f"[serve] cross-KV: encode_chunks={s['encode_chunks']} "
                  f"pages_in_use={eng.cross_pool.pages_in_use}/"
                  f"{eng.cross_pool.num_pages}")
        if eng.drafter is not None:
            print(f"[serve] spec decode: proposed={s['draft_proposed']} "
                  f"accepted={s['draft_accepted']} "
                  f"acceptance_rate={s['acceptance_rate']:.2f}")
        if cfg.n_experts:
            # drops (capacity factor, evicted experts) leave no trace in
            # the streams: the drop rule zeroes the expert's contribution
            print(f"[serve] moe: routed={s['moe_tokens_routed']} "
                  f"dropped={s['moe_dropped_tokens']} "
                  f"rank_imbalance={s['expert_imbalance']:.2f} "
                  f"placements={s['placement_updates']}")
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
