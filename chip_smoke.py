"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):

1. device      — a CUDA card must be visible; prints its name and power
                 limit.
2. build       — compiles the CUDA kernels from ``src/repro_torch/csrc``
                 (one nvcc per source, all at once) and prints what ptxas
                 reports of the flash-attention kernels' (both routes, the
                 backward's too), the
                 D 97-128 paged-attention split kernels' and the combine
                 kernels', the K-64 wkv kernels' (both routes: the
                 CUDA-core time loop, and the tensor-core route's chunk
                 states, chunk-state pass and outputs) and the N = P = 64
                 SSD kernels' (the CUDA-core loop, and the tensor-core
                 route's segment states and outputs) registers, spills and
                 shared memory, with the tensor-core routes' dynamic shared
                 memory; and the K = V = 64 wkv and N = P = 64 SSD
                 backward kernels'.
3. parity      — each kernel against its plain PyTorch version at the main
                 paths' shapes, with the tolerances printed beside them;
                 RMSNorm's three variants (the norm, the residual add fused
                 into it, Mamba-2's SiLU gate fused into it) at every row
                 count the main runs launch (1 to 4097 rows, main-spec's
                 verify forwards' 12 and 20 and its drafter's 512; d 3584,
                 7168, 2048, an odd 1001 and qwen2.5-14b's 5120), the fused
                 add's sum bit for bit; paged attention at G 7, 2 and 5
                 (qwen2.5-14b's 40/8 heads) and 16 (qwen3-moe's 64/4, float
                 and int8 pages; RMSNorm also at its d 4096 and its QK-norm's
                 128);
                 flash attention on its tensor-core route (bf16, D 64, 128
                 and 256: S 1024, 2048, a ragged 1000, a window, Sq != Sk,
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
23. main-disagg — main through the launcher's ``--disagg`` (a prefill-only
                 engine and a decode engine on one copy of the weights, a
                 KV page handoff between them, the two stages driven by
                 ``run_stages``): the serial executor, the thread executor,
                 then int8 KV pages (serial).  Each run is served as main
                 is (kernels only, B1 split), every request goes through
                 one handoff and one injection, both pools are whole after
                 the drain, B1 and B2 launch L and 1 + 2L times a role's
                 chunk or step (in the serial runs counted inside each
                 role's stage; in the thread run, where the stages
                 overlap, the run's total), and the streams equal main's
                 (main-int8's for int8 pages).  Prints the measured
                 launches by role, the peak
                 device memory against main's, wall tok/s of serial against
                 thread, and one handoff of 19 pages (a 300-token prompt)
                 as device time beside its bytes bound.  Then B1 timed at
                 qwen2.5-14b's heads (G 5: decode B 4, W 1 and a W 64
                 chunk).
24. main-14b   — full-width, full-depth qwen2.5-14b (48 layers, d 5120,
                 40/8 heads, bf16, random weights from seed 0, no cut)
                 with main's request mix: the monolithic paged engine,
                 then the disaggregated pair on the same weight tensors;
                 both through the kernels only, the streams equal, both
                 pools whole; prints the weights' bytes and the peak
                 device memory of each run.  main-mesh: the same weights
                 through ``ServeEngine(mesh=make_mesh((1,), ("model",)))``
                 inside ``run_ranks(world=1)`` (a real NCCL group of one:
                 the all-reduces and the vocab gather run): the streams
                 and B1/B2 launches equal the monolithic run's, its peak
                 at most 0.5 GB above; the decode step and a chunk
                 without and through the mesh in turns (profiled device
                 time, NCCL's share apart, and host-issued).
25. traffic-disagg — phase 22 through ``--disagg``: the same report gates,
                 printed beside the monolithic run's TTFT/ITL p50/p99,
                 tok/s and first-to-second-token gap.
26. MoE         — the serial MoE path (ROADMAP A9a), every earlier
                 phase's tensors freed first.  B1 timed at qwen3-moe's
                 heads (G 16: 64/4, decode B 4 W 1 and a W 64 chunk, over
                 94 layers' pools).  main-moe: qwen3-moe-235b-a22b at full
                 width (d 4096, 64/4 heads, QK-norm, 128 experts top-8,
                 bf16) cut to 12 layers, main's mix monolithic, then
                 disaggregated on the same weights: streams equal, B1 L and
                 B2 1 + 4L a step, the telemetry exact (routed = top_k x L
                 x the rows the paged calls were fed, dead slots and pad
                 included; the per-expert counts add up); its decode step
                 and a prefill chunk host-issued and as device time beside
                 the bytes bound.  main-moe-placed: the same at 6 layers,
                 unplaced, then through the dense per-slot path (flash
                 attention at 64/4 on the tensor cores, L a prefill), then
                 with the experts re-placed every 2 ticks: the placed
                 streams and telemetry equal the unplaced ones.
                 main-moe-mesh: main-moe's weights through an (expert 1,
                 model 1) mesh of one NCCL rank (the all-to-alls and the
                 tiled expert gather run): streams, B1/B2 launches and the
                 five MoE stats equal the monolithic run's, the peak at
                 most 1 GB above, the steps in turns as main-mesh's;
                 main-moe-placed-mesh: the placed run through that mesh
                 (each re-placement gathers a layer's shards at a time),
                 equal to the serial placed run, peak within 1 GB.
                 main-arctic: arctic-480b (d 7168, 56/8 heads, 128 experts
                 top-2 beside the dense MLP) cut to 2 layers, as main-moe.
                 moe-block: one full-width qwen3-moe layer on 64 tokens,
                 bf16 weights against float32 on the card: equal
                 telemetry, relative L2 within 2e-2.  Then B1 at the
                 per-rank heads of tensor parallelism (qwen2.5-14b at tp
                 2, 4, 8; qwen3-moe at 2, 4; qwen2-7b at 2, 4), decode and
                 a 64-row chunk, bf16: parity, then timed beside gather +
                 SDPA and the bound; the time the mesh phases add.
27. multimodal  — multimodal serving (ROADMAP A10).  B3 and B1 timed at
                 its shapes (MM_FLASH, MM_PAGED: whisper's encode chunk,
                 a clip's last chunk of 32 frames with 28 valid keys, a
                 full chunk's keys cut to 28 and 1, a whole 1500-frame
                 clip, llava's S 2944 prefill, qwen3-moe's G 16 at 512;
                 B1 at G 1 / D 64 at decode, verify windows of 3 and 5
                 and a chunk, and 188-page tables) beside SDPA (gather +
                 SDPA for B1) and the bound; the parity phase holds them
                 against their plain versions first.  Each of the two
                 phases below records every shape its serving calls give
                 B1 and B3 and holds the kernels against their plain
                 versions at each of them.  main-vlm:
                 llava-next-mistral-7b at full width and depth (32 layers,
                 d 4096, 32/8 heads of 128, 2880 image tokens, bf16) through
                 the launcher's ``--image``: 8 requests over two
                 alternating images, 32 new tokens each, 4 slots of 3008;
                 B1 and B2 exactly L and 1 + 2L a step or chunk (every B1
                 call split), the exact prefix hits (4 of 2896 tokens),
                 the pool whole; two identical image requests equal (or
                 parting only at a near-tie: margin below NEAR_TIE); the
                 prefix cache against a fresh prefill (prefix_cache_trace:
                 the engine's fresh and cached token-0 logits bit-equal
                 to model-level prefills over fresh pages; at GATE_DEPTH
                 layers in float32 fresh and cached within
                 CACHE_F32_TOL, the other image's pages beyond it); the
                 decode step and an image chunk 2816 deep timed.
                 main-whisper: whisper-tiny at full width (4 + 4 layers, d
                 384, 6 heads of 64, 1500 frames) through ``--audio``: 8
                 requests over two clips, 24 encode chunks each, B3 4
                 launches an encode chunk (all on the tensor cores), B1 4 a
                 decode step or decoder chunk, no plain version, both
                 pools whole; an identical pair, and the launcher's own
                 stream against it, under the near-tie rule; ngram
                 speculation's streams against the plain ones under the
                 same rule; the decode step, a decoder chunk and an
                 encode chunk timed.
28. science-runtime — the paper's parabola (32 x 32 tasks) through the
                 serial host loop, SerialExecutor, VmapExecutor,
                 MeshExecutor over a real NCCL group at world 1 and the
                 thread farm (8 workers, deadline factor 3): the counts
                 equal, the outputs within 1e-5 of the serial executor's;
                 the farm's steals, rebalances and stragglers.
29. science-mcmc — ideal points of 700 members from 5000 synthetic roll
                 calls (seed 1), 4 chains x 200 iterations through
                 VmapExecutor: |corr| with the true points > 0.95, the
                 largest R-hat printed; a Gibbs iteration's device time
                 beside its threefry draws'; a small chain card == CPU
                 within 1e-3.
30. science-dmc — 2^18 walkers (capacity 2^20, tau 0.01): serial 400
                 steps, the load-balanced SPMD driver over NCCL at world 1
                 for 200, 4 replicas of 2^16 x 300 steps on the thread farm
                 and again serially (the same energies): every E0 within
                 0.1 of 1.5, no population extinct or at capacity; a
                 walker step's device time beside its draws'.
31. science-boussinesq — a 2048 x 2048 grid, 50 steps, serial and through
                 the Schwarz route over NCCL at world 1: relative mass
                 drift < 1e-5, the routes within 1e-5, every step's
                 iterations under the cap; a Jacobi iteration timed;
                 48 x 48 card == CPU within 1e-5.
Each science phase prints its sizes, wall time and peak device memory; no
TPU kernel lies on their path, and each leaves no process group behind.

One-card training (ROADMAP A13a) and gemma3's window caches (A11):

32. parity-train — right after the parity phases: B2's backward kernel
                 (the norm, the fused add with its sum read on and not) at
                 training's (rows, d) (TRAIN_NORM_CASES: qwen3-1.7b's 8192
                 x 2048 and QK-norm rows at d 128, gemma3's d 2560 and
                 256), bf16 and float32, and B3's backward (bf16 D 128 S
                 2048 16/8 causal, D 256 S 2048 8/4 window 1024, a ragged
                 S 1000, D 64 non-causal, D 128 16/4 window 512, float32
                 D 16, and qwen3-moe's bf16 D 128 S 2048 64/4 causal at
                 G 16), each against autograd through the plain version in
                 float32 on the same inputs, the limits printed with their
                 reasons; every bf16 D 64/128 call on the backward's
                 tensor-core route (counted ``flash_attention_bwd_tc``);
                 then B3 with a query offset (sequence parallelism's
                 blocks: bf16 D 128 Sq 1024 / Sk 2048 at 1024, the same
                 with window 512, float32 D 64 Sq 130 / Sk 260 at 130, Sk
                 - Sq 133 at D 128), forward under TOL and backward under
                 the limits above, every call a launch (bf16 D 64/128 on
                 the tensor cores), counted apart.  Then the recurrent
                 families' backward kernels: B4's (B 2, S 256 and a
                 ragged 200, H 4, K = V = 64, a nonzero state, and a case
                 with decays at 0 and denormal), B5's (B 2, S 256, H 8,
                 N = P = 64), r/k/v and B/C float32 and bf16, the gated
                 norm's at (8192, 7168) bf16 and B3 at head dim 112 (B 1,
                 S 2048, 32/32, bf16 causal, forward under TOL), each
                 against autograd through its plain version in float32
                 and run twice: the same bits.
33. small-train — after the small phases: 5 trainer steps of float32
                 SMOKE qwen3-1.7b on the card against the CPU from the same
                 seeded weights and batches: losses within 1e-4, gradient
                 norms within 1e-3.
34. main-train — after the science phases: full-width, full-depth
                 qwen3-1.7b (28 layers, d 2048, 16/8 heads of 128, vocab
                 151936; float32 weights and AdamW moments, bf16 compute,
                 remat full) through ``Trainer`` at 4 x 2048 for 20 steps:
                 every loss finite and the last below the first; B3 56
                 launches a step (28 and 28 recomputed), all on the tensor
                 cores, its backward 28, all on the tensor cores; B2 113
                 forward launches a step
                 twice but the final norm's, its backward 113 (56 of the
                 fused add); no other kernel, no plain version; B3 and B2,
                 forward and backward, held against their plain versions
                 at every shape the steps called them at.  Prints the
                 losses, a step's host-issued and (profiled) device ms,
                 tokens/s and the peak memory beside the state's 16 B a
                 param; then a checkpoint of the full width cut to 2 layers
                 saved and restored bit for bit.
34b. main-train-mesh — right after main-train: its first 5 steps through
                 ``Trainer`` on ``make_debug_mesh(1, 1)`` in a
                 ``run_ranks`` world of 1 over NCCL (the state sharded at
                 birth, each block gathering its layer inside its body,
                 K/V gathered over "model", gradients reduce-scattered):
                 losses and gradient norms within 1e-5 of main-train's
                 (bit equality expected and reported), B2/B3 launches a
                 step (forward and backward) main-train's, the peak
                 within 1.10 x main-train's; a step host-issued and
                 profiled device time with NCCL's share.  Then pod-dp: a
                 (1, 1, 1) ("pod", "data", "model") mesh, 3 steps int8 +
                 error feedback and 3 plain from the seeded state: the
                 last losses within 0.05, the wire under 0.3 of float32;
                 step times.
34c. main-train-dots — main-train's config, seed and batches for 3 steps
                 under ``remat="dots"`` (the blocks' 2-D products saved,
                 everything else, B2's and B3's autograd Functions
                 included, recomputed): losses within 1e-6 of main-train's
                 first 3 (bit equality expected and reported), B2/B3
                 launches a step main-train's, no plain version; the peak
                 and a step's profiled device time beside main-train's.
34d. main-train-moe — full-width qwen3-moe-235b-a22b (d 4096, 64/4 heads of
                 128, 128 experts top-8 of ff 1536, vocab 151936, QK-norm)
                 cut to 2 layers (its 6.22 B params x 8 B of bf16 state,
                 49.8 GB; a third layer would add 19.9 GB), bf16 params
                 and AdamW moments as its config declares, bf16 compute,
                 remat full, through ``Trainer`` at 4 x 2048 for 10 steps:
                 every loss and aux finite and the last loss below the
                 first; B3 4 launches a step and its backward 2, all on
                 the tensor cores at G 16; B2's launches a step as in
                 main-train; no plain version; B3 and B2, forward and
                 backward, held against their plain versions at every
                 shape the steps called them at.  Prints the losses and
                 aux a step, a step's host-issued and profiled device ms,
                 tokens/s and the peak beside the state's bytes.  arctic's
                 13.4 B expert params a layer take 107 GB of state alone:
                 it trains at SMOKE on the CPU only.
34e. main-train-rwkv — right after main-train: full-width, full-depth
                 rwkv6-3b (32 layers, d 2560, 40 heads of 64, vocab 65536:
                 3.27 B params, 52.4 GB of float32 state; bf16 compute,
                 remat full) through ``Trainer`` at 4 x 2048 for 5 steps:
                 every loss finite and the last below the first; B4 64
                 launches a step (32 and 32 recomputed, all on the tensor
                 cores) and its backward 32; no other kernel, no plain
                 version; two forward and backward passes from the final
                 state the same bits.  Prints the losses, a step's
                 host-issued and profiled device ms by kernel group,
                 tokens/s and the peak beside the state's 16 B a param.
34f. main-train-zamba — full-width zamba2-7b (d 3584, 112 SSM heads of 64,
                 N 64, 32/32 attention heads of 112, ff 14336) cut from 81
                 to 27 Mamba-2 layers (one segment, one application of the
                 shared block: 2.54 B params, 40.6 GB of state), as 34e:
                 B5 54 + 27 backward a step (tensor cores forward), B2 111
                 (55 fused with the add, 54 gated) + 57 backward (29 and
                 27), B3 at D 112 1 + 1 on the tensor cores (zero-padded
                 to 128); B2 and B3 held against their plain versions at
                 every shape the steps called them at, forward and
                 backward.
35. main-gemma3 — full-width, full-depth gemma3-4b (34 layers: 29 windowed
                 of 1024, 5 global; d 2560, 8/4 heads of 256, vocab
                 262144, bf16, seed 0) as aligned batches through its API:
                 4 prompts of 2000 tokens (the ring compressed, then
                 wrapped each step) and 4 of 300 (the ring left-padded),
                 greedy to 32: B3 34 launches a prefill (29 windowed, 5
                 global, all on the tensor cores) and none at decode, B2
                 69 + 68 fused a prefill or step, nothing else; B3 and B2
                 held against their plain versions at every shape a batch
                 called them at; teacher
                 forcing (the last decode step against a prefill of the
                 same tokens) within GEMMA_BF16_TOL at full depth, the
                 argmax equal but at near-ties, and at the first 6 layers
                 in float32 within GEMMA_F32_TOL; a prefill and a decode
                 step host-issued and as profiled device time, idle share.
36. timing-train — B3 at gemma3's prefill shapes (B 4, S 2048, window 1024
                 and global; a replayed CUDA graph), B3's backward at
                 main-train's, gemma3's and main-train-moe's (B 4, S 2048,
                 64/4 heads of 128: G 16) shapes and B2's backward at
                 main-train's (rows, d) (device time of calls queued
                 behind a spin, autograd's included), each beside its
                 plain version,
                 one PyTorch yardstick (SDPA with the same mask, SDPA's
                 backward, ``F.rms_norm``'s backward with the same float32
                 scale; beside an unwindowed row also SDPA with
                 ``is_causal=True``, which can take its flash backend where
                 an explicit mask cannot) and its bound; B3 forward and
                 backward at the sequence-parallel block (B 4, Sq 1024 at
                 offset 1024, Sk 2048, 16/8 heads of 128, bf16) beside
                 SDPA with the same mask (explicit, and
                 ``causal_lower_right``) and the bound, with the card's
                 name and power limit.  The recurrent families' rows: B4's
                 backward at main-train-rwkv's shape and B5's at
                 main-train-zamba's (beside the plain autograd on one of
                 the 4 rows, which also holds the kernels' gradients of
                 that row at S 2048, and B4's du from a call on it alone,
                 under parity-train's limits; no single PyTorch call),
                 the gated norm's at
                 (8192, 7168), B3 at head dim 112 forward and backward at
                 main-train-zamba's shared block (B 4, S 2048, 32/32)
                 beside SDPA with the same mask and with ``is_causal``.

zamba2 has no serving-engine mode, as in the reference: phases 16-18 call
the model's API (``prefill``, ``lm_head``, ``decode_step``) directly; so
does main-gemma3 (the reference's window-cache decode is aligned-only).

The line before the last is the ``{"kernels": [...]}`` record; the last is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import gc
import json
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch.apps import boussinesq as bq  # noqa: E402
from repro_torch.apps import dmc, mcmc  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.core import comm as comm_lib  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.launch import apps as apps_launch  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.module import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve import pages as PG  # noqa: E402
from repro_torch.serve import prng  # noqa: E402
from repro_torch.serve import quant as QZ  # noqa: E402
from repro_torch.serve import sampling as SM  # noqa: E402
from repro_torch.serve.disagg import DisaggServeEngine  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    ServeEngine, encoder_prefix_tokens)

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
# main-vlm's prefix cache against a fresh prefill at GATE_DEPTH layers in
# float32: the cached request recomputes its last page in a chunk of
# another row count, a rounding gap about 2^-16 of bf16's (main-dense's
# float32 K gap is 3e-7 at layer 1); a wrong cache entry (the other
# image's pages) moves token 0's logits (~1 rms) by O(1)
CACHE_F32_TOL = 1e-3
# main-sampled: the heads (k 40, T 0.8; p 0.9, T 0.8; T 0.8) cycled over
# main's 8 requests, each seeded; the histogram's logit row and draws; its
# bound: the chi-square of 7 degrees of freedom at p = 0.001
SAMPLE_T = 0.8
HIST_LOGITS = (2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, 0.2)
HIST_DRAWS = 100_000
CHI2_BOUND = 24.32
# traffic: 16 Poisson arrivals at 2 requests a second (main serves its 8
# requests closed-loop at several a second; printed beside it)
# the science phases' sizes (PERF.md §4): the farm of examples/quickstart.py;
# a European Parliament term (410-751 members, thousands of roll calls);
# DMC (walkers, capacity, steps) serial, (walkers, steps) at world 1, and
# (replicas, walkers, steps) on the farm; Boussinesq (grid side, steps)
SCI_FARM_WORKERS, SCI_DEADLINE = 8, 3.0
SCI_MCMC = (700, 5000)
SCI_DMC_SERIAL = (2**18, 2**20, 400)
SCI_DMC_PARALLEL = (2**18, 200)
SCI_DMC_REPLICAS = (4, 2**16, 300)
SCI_BQ = (2048, 50)
STORE_DIR = pathlib.Path(__file__).resolve().parent / "build" / "ranks"
# main-disagg's handoff timed at a 300-token prompt: 19 pages of 16
HANDOFF_PAGES = 19
# the serial MoE path at full width (PERF.md §4): qwen3-moe cut from 94 to
# 12 layers (62.2 GB of bf16 weights), and to 6 for the placed run, whose
# placed copy of the experts sits beside the pristine tree; arctic cut
# from 35 to 2 (55.4 GB); the placed run re-places every 2 ticks
MOE_ARCH, ARCTIC_ARCH = "qwen3-moe-235b-a22b", "arctic-480b"
MOE_LAYERS, MOE_PLACED_LAYERS, ARCTIC_LAYERS = 12, 6, 2
MOE_PLACE_EVERY = 2
# moe-block: one full-width qwen3-moe layer on 64 tokens, bf16 weights
# against the same weights in float32.  The bf16 path rounds the expert
# input rows, the gate/up products, the SiLU product and the output to
# bf16 (unit roundoff 2**-9 ~ 2e-3, the GEMMs accumulate in float32), so
# the relative L2 gap should be a few times 2e-3; the gate is 2e-2
MOE_BLOCK_TOKENS = 64
MOE_BLOCK_REL = 2e-2
# the serving mesh at world 1 (one NCCL rank): main-mesh on main-14b's
# weights, main-moe-mesh on main-moe's, the placed run on main-moe-placed's;
# the peak of a mesh run may exceed its unmeshed twin's by this much at
# most (a second copy of any weight tensor would exceed it)
MESH_PEAK_SLACK = {"main-mesh": 2**29, "main-moe-mesh": 2**30,
                   "main-moe-placed-mesh": 2**30}
MOE_STATS = ("moe_tokens_routed", "moe_dropped_tokens", "expert_tokens",
             "expert_imbalance", "placement_updates")
# B1 at the per-rank heads of tensor-parallel serving: (arch, tp)
SHARD_HEADS = (("qwen2.5-14b", 2), ("qwen2.5-14b", 4), ("qwen2.5-14b", 8),
               ("qwen3-moe-235b-a22b", 2), ("qwen3-moe-235b-a22b", 4),
               ("qwen2-7b", 2), ("qwen2-7b", 4))
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
# 2048, one off the kernel's 16-byte vector (its scalar route),
# qwen2.5-14b's 5120 (main-14b), qwen3-moe's 4096 and its QK-norm's 128
# (main-moe; arctic is 7168)
NORM_ROWS = (1, 4, 12, 20, 64, 512, 1000, 1024, 4000, 4097)
NORM_DIMS = (3584, 7168, 2048, 1001, 5120, 4096, 128)
# (rows, d) of each B2 variant in the main runs: decode, prefill chunk,
# dense prefill, zamba2 prefill (the first norm, each Mamba layer's and the
# shared block's at d 3584, the gated norm at d_inner 7168), main-spec's
# verify forwards (12 and 20 rows) and drafter forward (512), main-14b's,
# main-moe's and main-arctic's decode step and prefill chunk at d 5120,
# 4096 and 7168 (4 and 64 rows); final_rmsnorm
# is the fused add of a model's last norm, which stores no sum
_QWEN_NORM_ROWS = [(4, 3584), (64, 3584), (1024, 3584), (4000, 3584),
                   (12, 3584), (20, 3584), (512, 3584), (4, 5120), (64, 5120),
                   (4, 4096), (64, 4096), (4, 7168), (64, 7168)]
# ... main-moe's QK-norm: q over B x 64 heads and k over B x 4 at d 128,
# decode (B 4: 256 and 16 rows) and a chunk (64: 4096 and 256 rows)
NORM_TIMED = {"rmsnorm": _QWEN_NORM_ROWS + [(16, 128), (256, 128),
                                            (4096, 128)],
              "add_rmsnorm": _QWEN_NORM_ROWS,
              "final_rmsnorm": _QWEN_NORM_ROWS,
              "gated_rmsnorm": [(4, 7168), (4000, 7168)]}
INT8_KV_BYTES = 29568              # qwen2-7b: 28 x 2 x 4 x (128 + 4) bytes
# (Hq, Hkv) of B1's float parity cases: qwen2-7b (G 7, also arctic's
# 56/8), G 2, qwen2.5-14b (G 5, main-14b's decode and chunk shapes) and
# qwen3-moe (G 16: 1024 rows a KV head in a W-64 chunk)
ATTN_HEADS = ((28, 4), (16, 8), (40, 8), (64, 4))
# (Hq, Hkv, D) of the int8 kernel's parity cases: qwen2-7b, SMOKE and
# qwen3-moe
INT8_HEADS = ((28, 4, 128), (4, 2, 16), (64, 4, 128))
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
               (1, 16, 16, 28, 4, 128, True, None),
               # qwen3-moe's heads (G 16): main-moe-placed's dense
               # prefills (bucket 512) and a ragged length
               (1, 512, 512, 64, 4, 128, True, None),
               (1, 300, 300, 64, 4, 128, True, None)]
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


def queued_ms(fn, iters: int = 10, warmup: int = 2,
              cycles: int = 400_000_000) -> float:
    """Mean device milliseconds a call of ``fn``, for calls a CUDA graph
    does not capture (autograd's backward): the card is held in a spin of
    ``cycles`` clocks (~0.2 s) while the host queues ``iters`` calls behind
    it, and CUDA events time the queue from the spin's end, so the calls
    run back to back at the card's pace.  Raises if the host took longer to
    queue them than the spin lasted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    spin, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    spin.record()
    torch.cuda._sleep(cycles)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if host >= spin.elapsed_time(start):
        raise AssertionError(f"queued_ms: the host queued the calls in "
                             f"{host:.1f} ms, past the card's "
                             f"{spin.elapsed_time(start):.1f} ms spin")
    return start.elapsed_time(end) / iters


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
        for Hq, Hkv in ATTN_HEADS:
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
    mm_errs = phase_parity_mm(rng, dev)
    for name in mm_errs:
        errs[name] = max(errs[name], mm_errs[name])
    tols = {k: {str(dt).split(".")[-1]: t for dt, t in v.items()}
            for k, v in TOL.items()}
    log(f"parity ok: {6 * len(NORM_ROWS) * len(NORM_DIMS)} rmsnorm (3 "
        f"variants; the fused add's s bit for bit) + "
        f"{16 * len(ATTN_HEADS)} paged_attention_mq (Hq/Hkv {ATTN_HEADS}) + "
        f"{2 * len(FLASH_CASES) + 1} flash_attention + "
        f"{12 * len(INT8_HEADS)} paged_attention_mq_int8 cases + {4 * len(SPLIT_CASES)} split "
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
    version ran, and the prefix cache hit (the prefiller's, for a
    disaggregated engine)."""
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
    stats = eng.stats
    if stats.get("prefill", stats)["prefix_hits"] <= 0:
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
    """B2's launches a decoder step: the first block's ln1 alone, every
    other norm (the other ln1s, each ln2, the final norm) with its residual
    add; with QK-norm (qwen3) also each layer's q and k norms alone."""
    L = cfg.n_layers
    return 1 + (2 * L if cfg.qk_norm else 0), 2 * L, 0


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


def paged_pools(cfg, rng, dev, dtype):
    """B1's timed inputs at ``cfg``'s heads: 4 slots' block tables of 32
    pages into 128-page pools, the slots' lengths, and one K/V pool pair a
    layer: every layer's pages together are larger than the 50 MB L2, so
    each call finds its K/V in HBM.  Returns (tables, lengths, layers)."""
    n_pages, P = 128, 32
    lens = np.array([300, 288, 310, 276], np.int32)
    tables = np.stack([rng.permutation(n_pages)[:P] for _ in range(4)])
    layers = [(torch.randn(n_pages + 1, PS, cfg.n_kv_heads, cfg.head_dim,
                           device=dev).to(dtype),
               torch.randn(n_pages + 1, PS, cfg.n_kv_heads, cfg.head_dim,
                           device=dev).to(dtype))
              for _ in range(cfg.n_layers)]
    return torch.tensor(tables.astype(np.int32), device=dev), lens, layers


def window_mask(ln, W: int, S: int):
    """The causal mask of ``W`` query positions a slot, the first at key
    ``ln - 1``, over ``S`` keys: (B, 1, W, S)."""
    return (torch.arange(S, device=ln.device)[None, None, :]
            < (ln[:, None] + torch.arange(W, device=ln.device))[:, :, None]
            )[:, None]


def sdpa_paged(q, kp, vp, tb, mask):
    """B1's yardstick: gather the slots' pages, then
    ``scaled_dot_product_attention`` under ``mask``."""
    import torch.nn.functional as F
    b, (Hkv, D) = tb.shape[0], kp.shape[-2:]
    k = kp[tb.long()].reshape(b, -1, Hkv, D).transpose(1, 2)
    v = vp[tb.long()].reshape(b, -1, Hkv, D).transpose(1, 2)
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k, v, attn_mask=mask[:b], enable_gqa=True)


def sdpa_paged_int8(q, kq, vq, ks, vs, tb, mask):
    """Composite yardstick of int8 pages: gather, dequantize (float32
    multiply, cast to q's dtype) and ``scaled_dot_product_attention``."""
    import torch.nn.functional as F
    b, t, (Hkv, D) = tb.shape[0], tb.long(), kq.shape[-2:]
    k, v = ((c[t].float() * sc[t][..., None]).to(q.dtype)
            .reshape(b, -1, Hkv, D).transpose(1, 2)
            for c, sc in ((kq, ks), (vq, vs)))
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k, v, attn_mask=mask[:b], enable_gqa=True)


def time_window(q, kvs, tb, ln, mask, scaled=False):
    """Device times of B1 (kernel, plain version, yardstick) at one window
    shape, each over every layer's pools in turn, and its bound: (times,
    bound ms, bound by)."""
    lib = sdpa_paged_int8 if scaled else sdpa_paged
    b, by = bound(*attention_cost(q, kvs[0][0], tb, ln, scaled=scaled),
                  q.dtype)
    t = {what: device_ms([lambda kv=kv: fn(kv) for kv in kvs])
         for what, fn in (
             ("kernel", lambda kv: ops.paged_attention_mq(
                 q, kv[0], kv[1], tb, ln, *kv[2:])),
             ("plain", lambda kv: ref.paged_attention_mq(
                 q, kv[0], kv[1], tb, ln, *kv[2:])),
             ("library", lambda kv: lib(q, *kv, tb, mask)))}
    return t, b, by


def phase_timing(dev) -> dict:
    """Kernel, plain-version and yardstick times at the main path's decode
    shapes (4 slots, bf16, qwen2-7b): device time from CUDA-graph replay,
    with the host-issued (eager) time printed beside."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_cuda
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

    # one page pool per layer, as in a decode step
    B, W, Hq, Hkv, D = 4, 1, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    tb, lens, layers = paged_pools(cfg, rng, dev, dtype)
    P = tb.shape[1]
    ln = torch.tensor(lens, device=dev)
    q = torch.randn(B, W, Hq, D, device=dev).to(dtype)
    mask = window_mask(ln, W, P * PS)

    int8_layers = [quantize_pages(kp.float(), vp.float())
                   for kp, vp in layers]
    nbytes, nops = attention_cost(q, layers[0][0], tb, ln)
    measure("paged_attention_mq", {
        "kernel": [lambda kv=kv: ops.paged_attention_mq(q, *kv, tb, ln)
                   for kv in layers],
        "plain": [lambda kv=kv: ref.paged_attention_mq(q, *kv, tb, ln)
                  for kv in layers],
        "library": [lambda kv=kv: sdpa_paged(q, *kv, tb, mask)
                    for kv in layers]},
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
        "library": [lambda kv=kv: sdpa_paged_int8(q, *kv, tb, mask)
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
        name = "flash_attention" if S == 1024 else f"flash_attention S={S}"
        measure(name, {
            "kernel": [lambda: ops.flash_attention(fq, fk, fv)] * 4,
            "plain": [lambda: ref.flash_attention(fq, fk, fv)] * 4,
            "library": [lambda: F.scaled_dot_product_attention(
                fq.transpose(1, 2), fk.transpose(1, 2), fv.transpose(1, 2),
                is_causal=True, enable_gqa=True)] * 4},
            f"prefill B=1 S={S} Hq={Hq} Hkv={Hkv} D={D} causal bf16",
            nbytes, nops)
        # the same launch writing each row's log-sum-exp, as training's
        # forward does: serving passes no pointer and writes none
        out[name]["with_lse_ms"] = device_ms(
            [lambda: flash_attention_cuda(fq, fk, fv, with_lse=True)] * 4)
        log(f"timing {name} with the log-sum-exp written (training's "
            f"forward): device {out[name]['with_lse_ms']:.5f} ms against "
            f"serving's {out[name]['ms']:.5f} ms")

    # the prefill-chunk shapes (one window of 64 at position 192): kept in
    # the B1 entries as chunk_*
    W2, start = 64, 192
    q2 = torch.randn(1, W2, Hq, D, device=dev).to(dtype)
    ln2 = torch.tensor([start + 1], dtype=torch.int32, device=dev)
    tb2 = tb[:1]
    mask2 = window_mask(ln2, W2, P * PS)
    for name, kvs, scaled in (("paged_attention_mq", layers, False),
                              ("paged_attention_mq_int8", int8_layers, True)):
        t2, b2, by2 = time_window(q2, kvs, tb2, ln2, mask2, scaled)
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
    mask5 = window_mask(ln, W5, P * PS)
    for name, kvs, scaled in (("paged_attention_mq", layers, False),
                              ("paged_attention_mq_int8", int8_layers, True)):
        t5, b5, by5 = time_window(q5, kvs, tb, ln, mask5, scaled)
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

# Two greedy streams of the same request may part only where the stream
# they are held against had a near-tie: its top-2 logit margin at the
# first divergence below this (bf16 logits; a divergence elsewhere fails)
NEAR_TIE = 0.05


def stream_gate(label, got: dict, want: dict, margins=None,
                near_tie: float = NEAR_TIE) -> list[str]:
    """Each stream of ``got`` against ``want``'s of the same key, one line
    a key: all equal, or the first divergence.  With ``margins`` (key -> the
    top-2 logit margin of each of ``want``'s tokens, in stream order) it is
    a gate: a divergence where that margin is not below ``near_tie`` fails
    (``near_tie`` 0: any divergence fails)."""
    lines = []
    for key in sorted(got):
        g, w = got[key], want[key]
        i = next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if i is None and len(g) == len(w):
            lines.append(f"{key}: all {len(g)} equal")
            continue
        i = min(len(g), len(w)) if i is None else i
        if margins is None:
            lines.append(f"{key}: first divergence at token {i}")
            continue
        ms = margins[key]
        m = ms[i] if i < len(ms) else float("inf")
        lines.append(f"{key}: first divergence at token {i}, margin {m:.4f}")
        if not m < near_tie:
            raise AssertionError(f"{label} {key}: the streams part at token "
                                 f"{i} where the margin is {m:.4f} (not a "
                                 f"near-tie: < {near_tie})")
    return lines


def finished_streams(eng) -> dict:
    """``eng``'s finished streams by request id."""
    return {r.rid: r.output for r in eng.finished}


class MarginSampler:
    """A greedy per-request sampler (the engine's default: the argmax over
    the true vocab) that records the top-2 logit margin of each token it
    picks, in stream order."""

    def __init__(self, vocab: int, keep: bool = False):
        self.vocab, self.margins = vocab, []
        self.logits = [] if keep else None      # with ``keep``: each row

    def __call__(self, key, logits):
        row = logits[..., :self.vocab].float()
        top = row.topk(2, dim=-1).values
        self.margins.append((top[..., 0] - top[..., 1]).item())
        if self.logits is not None:
            self.logits.append(row.clone())
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
        logits, _ = step(params, storage, tables, lengths, *window, **kw)
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
    lines = stream_gate(label, finished_streams(eng), ref_streams)
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
        lines = stream_gate(f"{label} depth {GATE_DEPTH} {drafter}",
                            finished_streams(on), ref_streams, margins,
                            near_tie=0.0)
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


def phase_traffic(main_rate: float, extra=(), label="traffic") -> dict:
    """An open-loop run through the launcher (``extra`` added to its
    arguments): 16 Poisson arrivals at the stated rate on the wall clock;
    the report must be complete (every request measured, no errors, every
    percentile, throughput and goodput), the paged path's kernels must
    launch and no plain version run.  Nothing else of the report is gated.
    Returns the report with each request's first-to-second-token gap."""
    args = launch_serve.parse_args(MAIN_ARGS + TRAFFIC_ARGS + list(extra))
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
        raise AssertionError(f"{label}: incomplete report {rep}")
    for name in PAGED_KERNELS:
        if counts[name][0] <= 0:
            raise AssertionError(f"{label}: {name} did not launch")
    if any(p for _, p in counts.values()):
        raise AssertionError(f"{label}: a plain version ran {counts}")
    gaps = second_token_gaps(res["events"])
    g = rep["goodput"]
    log(f"{label}: qwen2-7b paged{' disaggregated' if args.disagg else ''}, "
        f"{n} Poisson arrivals at {args.rate} "
        f"requests/s (main served {main_rate:.2f} requests/s closed-loop), "
        f"wall clock: TTFT p50 {rep['ttft']['p50']:.4f} s p99 "
        f"{rep['ttft']['p99']:.4f} s, ITL p50 {rep['itl']['p50']:.4f} s p99 "
        f"{rep['itl']['p99']:.4f} s, e2e p50 {rep['e2e']['p50']:.4f} s p99 "
        f"{rep['e2e']['p99']:.4f} s, {rep['tok_per_s']:.2f} tok/s over "
        f"{rep['span']:.3f} s, goodput {g['tok_per_s']:.2f} tok/s "
        f"(slo_attainment {g['slo_attainment']:.2f}, no SLO); first to "
        f"second token p50 {np.percentile(gaps, 50):.4f} s max "
        f"{max(gaps):.4f} s; launches {counts}")
    return dict(rep, second_token_gaps=gaps)


def second_token_gaps(events) -> list[float]:
    """Each request's wall seconds from its first token to its second, from
    the harness's event log (0 when both came out of one tick)."""
    seen, first, gaps = {}, {}, []
    for ev in events:
        if ev["kind"] != "tokens":
            continue
        rid = ev["rid"]
        before = seen.get(rid, 0)
        seen[rid] = before + ev["n"]
        if before == 0:
            first[rid] = ev["t"]
        if before < 2 <= seen[rid]:
            gaps.append(ev["t"] - first[rid])
    return gaps


# -- disaggregated prefill/decode: two engines, one page handoff --------------

@contextlib.contextmanager
def launches_by_role(names):
    """Kernel launches of ``names`` inside each role's stage of a
    disaggregated engine, measured: ``ops.COUNTS`` is read before and after
    every call of the two stage functions that ``run_stages`` drives.
    Yields ``{"prefill": {name: n}, "decode": {name: n}}``, filled as the
    stages run.  Exact under the serial executor only: there the stages
    never overlap."""
    roles = {role: dict.fromkeys(names, 0) for role in ("prefill", "decode")}
    saved = {attr: getattr(DisaggServeEngine, attr)
             for attr in ("_prefill_stage", "_decode_stage")}

    def counted(stage, acc):
        def run(self):
            before = {n: ops.COUNTS[n].kernel for n in names}
            try:
                return stage(self)
            finally:
                for n in names:
                    acc[n] += ops.COUNTS[n].kernel - before[n]
        return run

    for (attr, stage), role in zip(saved.items(), roles):
        setattr(DisaggServeEngine, attr, counted(stage, roles[role]))
    try:
        yield roles
    finally:
        for attr, stage in saved.items():
            setattr(DisaggServeEngine, attr, stage)


def check_disagg(label, eng, counts, attn, want, roles=None) -> dict | None:
    """Gates of a disaggregated run over main's 8 requests: served as main
    is (:func:`check_served`, every B1 call split), each request through
    one handoff and one injection, both pools whole after the drain (every
    page free or parked in the prefix cache, none held), and the streams
    equal to the monolithic run's ``want``; both roles serve the same weight
    tensors (one copy).  B1's and B2's launches must be the roles' steps
    times a step's: L a prefill chunk or decode step, and
    :func:`qwen_norms`' sum (1 + 2L; 1 + 4L with QK-norm).  With
    ``roles``, the launches measured in each role's stage
    (:func:`launches_by_role`, serial executor), each role's must equal its
    own steps' and the two must add up to the run's; without, only the
    run's total is held.  Returns ``roles``."""
    check_served(eng, label, counts,
                 PAGED_KERNELS if attn == "paged_attention_mq"
                 else INT8_KERNELS)
    pre, dec = eng.prefiller, eng.decoder
    check_split(label, counts, attn, dec.sched.pages_per_slot)
    n = (pre.stats["kv_handoffs"], dec.stats["kv_injections"])
    if n != (8, 8):
        raise AssertionError(f"{label}: handoffs, injections {n}, want 8 each")
    if not all(a is b for a, b in zip(tree_leaves(pre.params),
                                      tree_leaves(dec.params))):
        raise AssertionError(f"{label}: the roles hold two copies of the "
                             "weights")
    for role, e in (("prefill", pre), ("decode", dec)):
        pool = e.pool
        if (pool.pages_in_use or e.sched.held_pages()
                or pool.pages_free + pool.pages_cached != pool.num_pages):
            raise AssertionError(
                f"{label}: the {role} pool is not whole after the drain: "
                f"{pool.pages_free} free, {pool.pages_cached} cached, "
                f"{pool.pages_in_use} in use of {pool.num_pages}")
    cfg = eng.model.cfg
    L = cfg.n_layers
    steps = {"prefill": pre.stats["chunk_prefills"],
             "decode": dec.stats["ticks"] + dec.stats["chunk_prefills"]}
    need = {role: {attn: L * k, "rmsnorm": sum(qwen_norms(cfg)) * k}
            for role, k in steps.items()}
    for name in (attn, "rmsnorm"):
        if counts[name][0] != sum(r[name] for r in need.values()):
            raise AssertionError(f"{label}: {name} launched {counts[name][0]} "
                                 f"times; the roles' steps {steps} need "
                                 f"{need}")
        if roles is not None and (
                {r: roles[r][name] for r in need}
                != {r: need[r][name] for r in need}):
            raise AssertionError(f"{label}: {name} launched {roles} in the "
                                 f"roles' stages; their steps {steps} need "
                                 f"{need}")
    got = {r.rid: r.output for r in eng.finished}
    if got != want:
        raise AssertionError(f"{label}: streams differ from the monolithic "
                             f"run's: {streams_agree(eng, want)}")
    return roles


def memory_account(eng) -> str:
    """Device bytes of a disaggregated engine's weights (one copy, shared)
    and of each role's page pool, as printed text."""
    weights = sum(t.numel() * t.element_size()
                  for t in tree_leaves(eng.decoder.params))
    pools = {role: sum(t.numel() * t.element_size()
                       for t in e.pool.storage.values())
             for role, e in (("prefill", eng.prefiller),
                             ("decode", eng.decoder))}
    return f"weights {weights} B once, pools {pools} B"


def handoff_timing(eng, n_pages: int) -> dict:
    """Device time of one handoff of ``n_pages`` pages between the run's two
    pools (the prefiller's gather of every leaf, the decoder's scatter),
    replayed from a CUDA graph, beside its bytes and their bound: the copy
    is read and written by the gather and again by the scatter."""
    pre, dec = eng.prefiller.pool, eng.decoder.pool
    dev = dec.device
    src = torch.arange(n_pages, device=dev)[None]
    dst = torch.arange(n_pages, device=dev)
    kv = {}

    def handoff():
        for name, st in pre.storage.items():
            n = len(pre.leaf_specs[name].prefix)
            kv[name] = PG.gather_pages(st, src, n_prefix=n).squeeze(n)
        for name, st in dec.storage.items():
            PG.scatter_chunk(st, dst, kv[name], page_size=dec.page_size,
                             n_prefix=len(dec.leaf_specs[name].prefix))

    ms = device_ms([handoff])
    host = time_ms(handoff, iters=20, warmup=2)
    nbytes = sum(t.numel() * t.element_size() for t in kv.values())
    return dict(ms=ms, host_ms=host, bytes=nbytes,
                bound_ms=4 * nbytes / HBM_BYTES_PER_S * 1e3,
                positions=n_pages * dec.page_size)


def phase_main_disagg(main_peak, ref_streams, int8_streams) -> dict:
    """main through the launcher's ``--disagg``: the serial executor, the
    thread executor, then int8 KV pages (serial); each run gated by
    :func:`check_disagg` against main's or main-int8's streams.  Prints the
    roles' B1 and B2 launches, the device memory (the weights once, each
    role's pool; the run's peak above what earlier phases left allocated,
    beside main's peak), the wall tok/s of serial against thread, and the
    handoff of a 300-token prompt (19 pages) as device time against its
    bound.  Returns the serial run's launches by role and the handoff's
    timing."""
    out = {}
    for label, extra, attn, want in (
            ("serial", [], "paged_attention_mq", ref_streams),
            ("thread", ["--executor", "thread"], "paged_attention_mq",
             ref_streams),
            ("int8", ["--kv-quant", "int8"], "paged_attention_mq_int8",
             int8_streams)):
        gc.collect()
        base = torch.cuda.memory_allocated()
        if label == "thread":       # the stages overlap: the run's total
            roles = None
            eng, counts, wall, peak = serve_main(["--disagg"] + extra)
        else:
            with launches_by_role((attn, "rmsnorm")) as roles:
                eng, counts, wall, peak = serve_main(["--disagg"] + extra)
        peak -= base
        check_disagg(f"main-disagg {label}", eng, counts, attn, want, roles)
        toks = sum(len(r.output) for r in eng.finished)
        s = eng.stats
        kv_b = s["decode"]["kv_bytes_per_token"]
        log(f"main-disagg {label}: qwen2-7b, {len(eng.finished)} requests, "
            f"{toks} tokens, {toks / wall:.1f} tok/s wall (init included: "
            f"{wall:.2f}s); handoffs={s['prefill']['kv_handoffs']} "
            f"injections={s['decode']['kv_injections']}; prefill role "
            f"{s['prefill']['chunk_prefills']} chunks, decode role "
            f"{s['decode']['ticks']} ticks; launches measured by role "
            f"{roles or 'not split (the stages overlap)'}; "
            f"{kv_b} KV B a token; {memory_account(eng)}; peak above the "
            f"run's start {peak} B (main {main_peak} B); streams equal to "
            f"the monolithic run's; launches {counts}")
        out[label] = dict(roles=roles, tok_s=toks / wall, peak=peak)
        if label == "serial":
            t = handoff_timing(eng, HANDOFF_PAGES)
            out["handoff"] = t
            log(f"main-disagg handoff of {HANDOFF_PAGES} pages "
                f"({t['positions']} positions, {kv_b} B a token): "
                f"{t['bytes']} B, device {t['ms']:.5f} ms (gather + "
                f"scatter, every leaf), bound {t['bound_ms']:.6f} ms "
                f"(4 x bytes / {HBM_BYTES_PER_S:.3g} B/s), host-issued "
                f"{t['host_ms']:.5f} ms; a copy on one card, not a transfer "
                f"over a link")
        eng.close()
        del eng
    log(f"main-disagg: wall tok/s serial {out['serial']['tok_s']:.1f}, "
        f"thread {out['thread']['tok_s']:.1f}")
    return out


def phase_timing_heads(dev, cfg, tag: str, seed: int) -> dict:
    """B1 at ``cfg``'s heads, bf16, at main's two timed windows
    (:func:`phase_timing`): the decode step (4 slots, W 1) and a prefill
    chunk (W 64 at position 192), over ``cfg.n_layers`` layers' pools;
    device times of kernel, plain version and yardstick beside the bound,
    under keys ``{tag}_decode_*`` and ``{tag}_chunk_*``; the kernel held
    against its plain version on the first layer's pools first."""
    dtype = torch.bfloat16
    tb, lens, layers = paged_pools(cfg, np.random.default_rng(seed), dev,
                                   dtype)
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    out = {}
    for key, B, W, ln in (
            (f"{tag}_decode", 4, 1, torch.tensor(lens, device=dev)),
            (f"{tag}_chunk", 1, 64, torch.tensor([193], dtype=torch.int32,
                                                 device=dev))):
        q = torch.randn(B, W, Hq, D, device=dev).to(dtype)
        kp, vp = layers[0]
        err = check("paged_attention_mq", f"{key} (Hq {Hq}, Hkv {Hkv})",
                    ops.paged_attention_mq(q, kp, vp, tb[:B], ln),
                    ref.paged_attention_mq(q, kp, vp, tb[:B], ln), dtype)
        ms, b, by = time_window(q, layers, tb[:B], ln,
                                window_mask(ln, W, tb.shape[1] * PS))
        out.update({f"{key}_ms": ms["kernel"], f"{key}_plain_ms": ms["plain"],
                    f"{key}_library_ms": ms["library"],
                    f"{key}_bound_ms": b, f"{key}_bound_by": by,
                    f"{key}_max_abs_err": err})
        log(f"timing paged_attention_mq at G {Hq // Hkv} [{cfg.name} "
            f"{key.split('_')[1]} B={B} W={W} Hq={Hq} Hkv={Hkv} D={D}, "
            f"{cfg.n_layers} layers' pools, bf16]: device kernel "
            f"{ms['kernel']:.5f} ms, plain {ms['plain']:.5f} ms, library "
            f"{ms['library']:.5f} ms, bound {b:.6f} ms ({by})")
    del layers
    return out


def init_model(cfg):
    """``cfg``'s model with random weights from seed 0 on the card, every
    earlier phase's cached blocks released first: (model, params, seconds
    the init took, the device bytes allocated before it)."""
    model = build_model(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(0, device="cuda")
    torch.cuda.synchronize()
    return model, params, time.perf_counter() - t0, base


def engine_kw(args) -> dict:
    """The paged engine's arguments of a launcher command line."""
    return dict(max_slots=args.slots, max_len=args.max_len,
                page_size=args.page_size, prefill_chunk=args.prefill_chunk,
                prefix_cache=args.prefix_cache == "on", device="cuda")


@contextlib.contextmanager
def rows_fed(model):
    """The token rows the model's paged calls are fed, counted while the
    block runs: ``{"rows": n}``, every slot of a decode step (dead ones
    too) and every position of a prefill chunk or verify window (pad
    too), each the rows its MoE blocks route."""
    acc = {"rows": 0}
    names = ("paged_prefill_chunk", "paged_decode_step", "paged_verify")
    saved = {n: getattr(model, n) for n in names}

    def counted(fn, tok_arg):
        def call(*a, **kw):
            acc["rows"] += a[tok_arg].numel()
            return fn(*a, **kw)
        return call

    for n in names:     # tokens: the 6th argument of a chunk, else the 5th
        setattr(model, n, counted(saved[n], 5 if n == names[0] else 4))
    try:
        yield acc
    finally:
        for n in names:
            delattr(model, n)


def serve_counted(eng, prompts, max_new: int):
    """Serve ``prompts`` on a fresh engine with the counts and the peak mark
    zeroed first, B1's and B2's launches measured by role for a
    disaggregated engine, the rows fed to the paged calls counted
    (:func:`rows_fed`): (streams, launch counts, roles, peak device bytes,
    rows)."""
    with launches_by_role(("paged_attention_mq", "rmsnorm")) as roles, \
            rows_fed(eng.model) as fed:
        for p in prompts:
            eng.submit(p, max_new_tokens=max_new)
        eng.run_until_drained()
        torch.cuda.synchronize()
    counts = {k: (c.kernel, c.plain) for k, c in ops.COUNTS.items()}
    return ({r.rid: r.output for r in eng.finished}, counts, roles,
            torch.cuda.max_memory_allocated(), fed["rows"])


def check_moe_telemetry(label, cfg, engines, rows: int) -> dict:
    """The run's engines together routed top_k x L x the ``rows`` their
    paged calls were fed (:func:`rows_fed`), and each engine's per-expert
    counts add up to its routed total; returns the run's routed, dropped
    and per-expert totals."""
    out = {"routed": 0, "dropped": 0, "experts": np.zeros(cfg.n_experts,
                                                          np.int64)}
    for role, e in engines.items():
        s = e.stats
        if sum(s["expert_tokens"]) != s["moe_tokens_routed"]:
            raise AssertionError(
                f"{label} {role}: routed {s['moe_tokens_routed']}, per-expert "
                f"sum {sum(s['expert_tokens'])}")
        out["routed"] += s["moe_tokens_routed"]
        out["dropped"] += s["moe_dropped_tokens"]
        out["experts"] += np.asarray(s["expert_tokens"], np.int64)
    want = cfg.top_k * cfg.n_layers * rows
    if out["routed"] != want:
        raise AssertionError(f"{label}: routed {out['routed']}, want top_k x "
                             f"L x rows = {want} ({rows} rows fed)")
    return out


def mono_then_disagg(label, model, params, args, base: int) -> dict:
    """The launcher's 8 prompts for ``args`` through the monolithic paged
    engine, then the disaggregated pair (serial) on the same weight tensors
    (one copy).  Both served through the kernels only, B1 split, B2 as the
    steps need; the disaggregated streams equal the monolithic ones, each
    handoff injected once and both pools whole; an MoE model's telemetry
    exact (:func:`check_moe_telemetry`).  Returns per run: streams,
    counts, roles, stats, tok/s, wall, rows fed, peak above ``base`` (the
    device bytes allocated before the weights) and the MoE totals."""
    cfg = model.cfg
    prompts = launch_serve.make_prompts(args, cfg.vocab)
    kw = engine_kw(args)
    runs = {}
    for run, make in (("monolithic", lambda: ServeEngine(model, params,
                                                         **kw)),
                      ("disagg", lambda: DisaggServeEngine(model, params,
                                                           **kw))):
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counts()
        t0 = time.perf_counter()
        eng = make()
        streams, counts, roles, peak, rows = serve_counted(eng, prompts,
                                                           args.max_new)
        wall = time.perf_counter() - t0
        if run == "monolithic":
            check_served(eng, f"{label} monolithic", counts, PAGED_KERNELS)
            check_split(f"{label} monolithic", counts, "paged_attention_mq",
                        eng.sched.pages_per_slot)
            s = eng.stats
            check_norm_counts(f"{label} monolithic", counts,
                              s["ticks"] + s["chunk_prefills"],
                              qwen_norms(cfg))
            engines, stats = {"monolithic": eng}, s
        else:
            check_disagg(f"{label} disagg", eng, counts,
                         "paged_attention_mq", runs["monolithic"]["streams"],
                         roles)
            engines = {"prefill": eng.prefiller, "decode": eng.decoder}
            stats = eng.stats
        moe = (check_moe_telemetry(f"{label} {run}", cfg, engines, rows)
               if cfg.n_experts else None)
        toks = sum(len(o) for o in streams.values())
        runs[run] = dict(streams=streams, counts=counts, roles=roles,
                         stats=stats, tok_s=toks / wall, wall=wall,
                         rows=rows,
                         peak=peak - base, moe=moe,
                         memory=None if run == "monolithic"
                         else memory_account(eng))
        eng.close()
        del eng, engines
    return runs


def log_runs(label, cfg, runs, extra: str = "") -> None:
    """One line a run of :func:`mono_then_disagg`."""
    for run, r in runs.items():
        s = r["stats"]
        what = (f"ticks={s['ticks']} chunks={s['chunk_prefills']} "
                f"prefix_hits={s['prefix_hits']}" if run == "monolithic"
                else f"launches measured by role {r['roles']}; "
                f"{r['memory']}")
        moe = "" if r["moe"] is None else (
            f"; moe: routed={r['moe']['routed']} dropped="
            f"{r['moe']['dropped']} (top_k x L x {r['rows']} rows fed, "
            "exact)")
        toks = sum(len(o) for o in r["streams"].values())
        log(f"{label} {run}: {cfg.name} {cfg.n_layers} layers d "
            f"{cfg.d_model} Hq/Hkv {cfg.n_heads}/{cfg.n_kv_heads} "
            f"{cfg.dtype}{extra}, {len(r['streams'])} requests, {toks} "
            f"tokens, {r['tok_s']:.1f} tok/s wall ({r['wall']:.2f} s), "
            f"{what}{moe}; peak above the phase's start {r['peak']} B; "
            f"launches {r['counts']}")


def phase_main_14b() -> dict:
    """Full-width, full-depth qwen2.5-14b (48 layers, d 5120, bf16, random
    weights from seed 0, no cut) with main's request mix through
    :func:`mono_then_disagg`, then main-mesh: the same through a serving
    mesh of one NCCL rank (:func:`phase_mesh`).  Prints the weights'
    bytes, the peak device memory of each run, tok/s and the launches;
    returns main-mesh's wall seconds."""
    args = launch_serve.parse_args(["--arch", "qwen2.5-14b"] + MAIN_ARGS[2:])
    model, params, init_s, base = init_model(get_config(args.arch))
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    n_params = sum(t.numel() for t in tree_leaves(params))
    runs = mono_then_disagg("main-14b", model, params, args, base)
    log_runs("main-14b", model.cfg, runs)
    log(f"main-14b: {n_params} parameters, {weights} B of weights (one copy, "
        f"initialised in {init_s:.2f}s); disaggregated streams equal the "
        f"monolithic ones; peak monolithic {runs['monolithic']['peak']} B, "
        f"disagg {runs['disagg']['peak']} B")
    t0 = time.perf_counter()
    phase_mesh("main-mesh", model, params, args, base, runs["monolithic"],
               (1,), ("model",))
    del params
    return time.perf_counter() - t0


# -- the serving mesh at world 1: tensor and expert parallelism (A9b) ----------

def profiled_parts(fn, iters: int = 2) -> tuple[float, float, float]:
    """(device ms a call, of which NCCL's kernels, of which device-to-device
    copies) of ``fn``: the sums of its device times in a ``torch.profiler``
    trace of ``iters`` calls (a call with NCCL collectives is not captured
    in a CUDA graph here), after one warm-up call.  NCCL over a group of
    one rank launches no kernel: its gathers are copies."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = nccl = copies = 0.0
    for ev in prof.key_averages():
        total += ev.self_device_time_total
        if "nccl" in ev.key.lower():
            nccl += ev.self_device_time_total
        elif "memcpy dtod" in ev.key.lower():
            copies += ev.self_device_time_total
    if total <= 0:
        raise AssertionError("the profiler saw no device time")
    return total / iters / 1e3, nccl / iters / 1e3, copies / iters / 1e3


def profiled_ms(fn, iters: int = 2) -> tuple[float, float]:
    """(device ms a call, of which NCCL's kernels) of ``fn``
    (:func:`profiled_parts`)."""
    return profiled_parts(fn, iters)[:2]


def kernel_group(name: str) -> str:
    """A device kernel's group in a training step's breakdown.  The scans'
    chunk passes (``chunk_pass_kernel<reverse, row_decay>``) are B4's
    with a decay a state row, B5's with one a head."""
    k = name.lower()
    if "chunk_pass_kernel<" in k:
        args = k.split("chunk_pass_kernel<", 1)[1].split(">", 1)[0]
        return "B4" if args.replace(" ", "").endswith(",true") else "B5"
    for group, keys in (("B3", ("fa_bwd", "flash_attention")),
                        ("B2", ("rmsnorm",)),
                        ("B4", ("rwkv6",)),
                        ("B5", ("ssd_",)),
                        ("GEMM", ("gemm", "xmma", "cutlass", "nvjet")),
                        ("index", ("index", "scatter", "gather")),
                        ("copy/fill", ("memcpy", "memset", "fill")),
                        ("reduction", ("reduce",)),
                        ("elementwise", ("elementwise", "vectorized",
                                         "unrolled"))):
        if any(key in k for key in keys):
            return group
    return "other"


def train_step_split(model, opt, state, batch) -> dict:
    """One train step of ``state`` on ``batch`` in its two parts, each
    timed by CUDA events with its peak apart: the loss's forward and
    backward (``make_grads_fn``) and AdamW; then one whole step
    (``make_train_step``) profiled, its device time summed by
    :func:`kernel_group`.  The state is updated by both."""
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.train import make_train_step
    from repro_torch.train.step import make_grads_fn
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev[0].record()
    _, _, grads = make_grads_fn(model)(state["params"], batch)
    ev[1].record()
    torch.cuda.synchronize()
    out = {"peak_grads": torch.cuda.max_memory_allocated()}
    torch.cuda.reset_peak_memory_stats()
    ev[2].record()
    adamw_update(state["params"], grads, state["opt"], opt)
    ev[3].record()
    torch.cuda.synchronize()
    out.update(peak_adamw=torch.cuda.max_memory_allocated(),
               grads_ms=ev[0].elapsed_time(ev[1]),
               adamw_ms=ev[2].elapsed_time(ev[3]))
    del grads
    step = make_train_step(model, opt)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    groups = collections.Counter()
    for e in prof.key_averages():
        groups[kernel_group(e.key)] += e.self_device_time_total / 1e3
    out["device_ms"] = sum(groups.values())
    if out["device_ms"] <= 0:
        raise AssertionError("the profiler saw no device time")
    out["groups"] = {g: round(t, 1) for g, t in groups.most_common()}
    return out


def split_line(sp: dict) -> str:
    """:func:`train_step_split`'s numbers as a log line's tail."""
    return (f"device {sp['device_ms']:.1f} ms by group {sp['groups']}; the "
            f"loss's forward and backward {sp['grads_ms']:.1f} ms (peak "
            f"{sp['peak_grads']} B), AdamW {sp['adamw_ms']:.1f} ms (peak "
            f"{sp['peak_adamw']} B) by CUDA events")


def mesh_step_turns(model, eng) -> dict:
    """The decode step and prefill chunk of :func:`step_fns` on the mesh
    engine's pool, without a transport ("plain") and through the mesh's
    (the all-reduces, the vocab gather, an MoE block's all-to-alls and
    expert gather on one NCCL rank), in turns plain, mesh, mesh, plain:
    host-issued ms and profiled device ms (NCCL's share apart) a call,
    {name: {"plain" | "mesh": [(host, device, nccl), ...]}}."""
    mesh_kw = {k: eng._paged_kw[k] for k in ("comm", "ep_comm")}
    out = {}
    for name, fn in step_fns(model, eng.params, eng).items():
        res = {"plain": [], "mesh": []}
        for which in ("plain", "mesh", "mesh", "plain"):
            call = functools.partial(fn, **({} if which == "plain"
                                            else mesh_kw))
            res[which].append((time_ms(call, iters=3, warmup=1),
                               *profiled_ms(call)))
        out[name] = res
    return out


def _mesh_rank(comm, model, params, args, shape, names, prompts,
               placement_interval, steps):
    """A world-1 rank: the paged engine on ``make_mesh(shape, names)``
    serving ``prompts`` (:func:`serve_counted`, the peak and counts zeroed
    first), then, with ``steps``, :func:`mesh_step_turns`."""
    mesh = comm_lib.make_mesh(shape, names)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    eng = ServeEngine(model, params, mesh=mesh,
                      placement_interval=placement_interval,
                      **engine_kw(args))
    streams, counts, _, peak, rows = serve_counted(eng, prompts,
                                                   args.max_new)
    out = dict(streams=streams, counts=counts, peak=peak, rows=rows,
               stats=dict(eng.stats), wall=time.perf_counter() - t0,
               tp=eng.tp, ep=eng.ep,
               groups=[mesh.comm(a).size() for a in names])
    if steps:
        out["steps"] = mesh_step_turns(model, eng)
    eng.close()
    return out


def phase_mesh(label, model, params, args, base, twin, shape, names,
               placement_interval=0, steps=True) -> dict:
    """``label``: the launcher's prompts of ``args`` through the paged
    engine on a serving mesh of ``shape`` over ``names`` inside
    ``run_ranks`` at world 1 on the card (real NCCL groups of one), on the
    weights its unmeshed ``twin`` run served (one copy).  Gates: the
    streams, B1's and B2's launches and an MoE model's five MoE stats equal
    the twin's; the peak above ``base`` at most the twin's plus
    MESH_PEAK_SLACK (no second copy of the weights).  With ``steps``, the
    decode step and chunk plain vs through the mesh, in turns."""
    t0 = time.perf_counter()
    prompts = launch_serve.make_prompts(args, model.cfg.vocab)
    r = comm_lib.run_ranks(_mesh_rank, (model, params, args, shape, names,
                                        prompts, placement_interval, steps),
                           world=1, store_dir=STORE_DIR, device="cuda")[0]
    if torch.distributed.is_initialized():
        raise AssertionError(f"{label}: a process group was left")
    wall = time.perf_counter() - t0
    r["peak"] -= base
    if r["streams"] != twin["streams"]:
        raise AssertionError(f"{label}: the mesh streams differ from the "
                             "unmeshed run's")
    for name in PAGED_KERNELS:
        if r["counts"][name] != twin["counts"][name]:
            raise AssertionError(f"{label}: {name} launched "
                                 f"{r['counts'][name]}, unmeshed "
                                 f"{twin['counts'][name]}")
    if model.cfg.n_experts:
        for k in MOE_STATS:
            if r["stats"][k] != twin["stats"][k]:
                raise AssertionError(f"{label}: {k} {r['stats'][k]}, "
                                     f"unmeshed {twin['stats'][k]}")
    if r["peak"] > twin["peak"] + MESH_PEAK_SLACK[label]:
        raise AssertionError(f"{label}: peak {r['peak']} B above the "
                             f"unmeshed {twin['peak']} B + "
                             f"{MESH_PEAK_SLACK[label]} B")
    mesh = ", ".join(f"{n} {s}" for n, s in zip(names, shape))
    log(f"{label}: {model.cfg.name} {model.cfg.n_layers} layers through "
        f"ServeEngine(mesh=({mesh})) in run_ranks(world=1, NCCL): tp "
        f"{r['tp']}, ep {r['ep']}, groups of {r['groups']}; "
        f"{len(r['streams'])} requests equal to the unmeshed run token for "
        f"token; B1/B2 launches {[r['counts'][n] for n in PAGED_KERNELS]} "
        f"as unmeshed"
        + (f"; MoE stats equal (routed {r['stats']['moe_tokens_routed']}, "
           f"dropped {r['stats']['moe_dropped_tokens']}, placements "
           f"{r['stats']['placement_updates']})" if model.cfg.n_experts
           else "")
        + f"; peak above the weights' start {r['peak']} B (unmeshed "
        f"{twin['peak']} B, +{r['peak'] - twin['peak']} B); serve wall "
        f"{r['wall']:.2f} s (unmeshed {twin['wall']:.2f} s); phase "
        f"{wall:.1f} s")
    for name, res in r.get("steps", {}).items():
        mean = {w: np.mean(np.asarray(v), axis=0) for w, v in res.items()}
        (ph, pd, _), (mh, md, mn) = mean["plain"], mean["mesh"]
        log(f"{label} {name}, turns plain/mesh/mesh/plain: device "
            f"(profiled) plain {' / '.join(f'{v[1]:.3f}' for v in res['plain'])} "
            f"ms, mesh {' / '.join(f'{v[1]:.3f}' for v in res['mesh'])} ms "
            f"(+{md - pd:.3f} ms, {md / pd - 1:+.2%}; NCCL kernels "
            f"{mn:.3f} ms of it); host-issued plain "
            f"{' / '.join(f'{v[0]:.3f}' for v in res['plain'])} ms, mesh "
            f"{' / '.join(f'{v[0]:.3f}' for v in res['mesh'])} ms "
            f"({mh / ph - 1:+.2%})")
    return r


def phase_shard_heads(dev) -> dict:
    """B1 at the per-rank heads of tensor-parallel serving (SHARD_HEADS:
    the config's heads over tp), bf16, decode (4 slots) and a 64-row
    chunk over the full depth's pools: parity, then kernel, plain and
    gather + SDPA beside the bound (:func:`phase_timing_heads`)."""
    t0 = time.perf_counter()
    out = {}
    for i, (arch, tp) in enumerate(SHARD_HEADS):
        cfg = get_config(arch)
        cfg = cfg.replace(n_heads=cfg.n_heads // tp,
                          n_kv_heads=cfg.n_kv_heads // tp)
        tag = f"{arch.split('-')[0]}_tp{tp}"
        out[tag] = phase_timing_heads(dev, cfg, tag, 30 + i)
    log(f"B1 at the shard shapes: {len(SHARD_HEADS)} shapes in "
        f"{time.perf_counter() - t0:.1f} s")
    return out


# -- the serial MoE path: qwen3-moe and arctic at full width ------------------

def decode_cost(model, params, eng) -> tuple[int, int]:
    """(bytes, operations) a 4-slot decode step at lengths 300 +/- 12 must
    move and do: every block weight read once (all E experts, as the
    capacity-padded dispatch multiplies every expert's buffer), the
    embedding rows, the final norm and the unembedding; the slots' K/V
    rows; the logits written.  Operations: 2 a weight element a routed row
    (top_k experts), plus attention's 4 D a key a query head."""
    cfg = model.cfg
    B, L, d = eng.max_slots, cfg.n_layers, cfg.d_model
    blocks = sum(t.numel() * t.element_size()
                 for t in tree_leaves(params["blocks"]))
    unembed = params["unembed"]["w"]
    keys = sum([300, 288, 310, 276][:B])
    kv = keys * L * 2 * cfg.n_kv_heads * cfg.head_dim * 2
    nbytes = (blocks + B * d * 2 + d * 2 + unembed.numel() * 2 + kv
              + B * unembed.shape[1] * 4)
    expert = 3 * d * cfg.expert_d_ff
    per_row = (sum(t.numel() for t in tree_leaves(params["blocks"])) // L
               - cfg.n_experts * expert + cfg.top_k * expert)
    nops = 2 * B * (L * per_row + unembed.numel()) \
        + 4 * cfg.head_dim * cfg.n_heads * keys * L
    return nbytes, nops


def step_fns(model, params, eng) -> dict:
    """A 4-slot decode step at lengths 300 +/- 12 and a prefill chunk (64
    at 192) on ``eng``'s pool, each a function of the model call's extra
    keywords (a mesh's transports): {name: fn(**kw)}."""
    cfg, dev = model.cfg, eng.device
    storage = eng.pool.storage
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
    start, C = 192, 64
    row = tables[0]
    pages = row[start // PS:(start + C) // PS]
    chunk = torch.tensor(rng.integers(0, cfg.vocab, (1, C)).astype(np.int32),
                         device=dev)
    return {f"decode step ({B} slots)": lambda **kw: model.paged_decode_step(
                params, storage, tables, lens, toks, wp, wo, **kw),
            f"prefill chunk ({C} at {start})":
            lambda **kw: model.paged_prefill_chunk(
                params, storage, row, pages, start, chunk, **kw)}


def phase_step_moe(label, model, params, eng) -> dict:
    """One 4-slot decode step and one prefill chunk (64 at 192) of an MoE
    model on ``eng``'s pool (:func:`step_fns`), host-issued and as device
    time (a replayed CUDA graph), with the card's idle share; the decode
    step beside its bytes bound (:func:`decode_cost`) and beside the bound
    of the experts a step routes to (at most B x top_k a layer), which is
    what a dispatch that skipped empty experts would read."""
    cfg, B = model.cfg, eng.max_slots
    out = {}
    for name, fn in step_fns(model, params, eng).items():
        host = time_ms(fn, iters=5, warmup=2)
        devt = device_ms([fn], reps=5)
        out[name] = (host, devt)
        log(f"{label} {name}: host-issued {host:.3f} ms, device {devt:.3f} ms "
            f"(card idle {max(0.0, 1 - devt / host):.1%} of the host-issued "
            "time)")
    nbytes, nops = decode_cost(model, params, eng)
    b_ms, b_by = bound(nbytes, nops, torch.bfloat16)
    expert = 3 * cfg.d_model * cfg.expert_d_ff * 2
    live = min(cfg.n_experts, B * cfg.top_k)
    live_ms = (nbytes - cfg.n_layers * (cfg.n_experts - live) * expert) \
        / HBM_BYTES_PER_S * 1e3
    host, devt = out[f"decode step ({B} slots)"]
    log(f"{label} decode step against its bound: device {devt:.3f} ms, bound "
        f"{b_ms:.3f} ms ({b_by}: {nbytes} B at {HBM_BYTES_PER_S:.3g} B/s, "
        f"{nops} operations; the step at {b_ms / devt:.1%} of it); reading "
        f"only the <= {live} experts a layer the step routes to: "
        f"{live_ms:.3f} ms")
    return dict(decode_ms=devt, decode_host_ms=host, bound_ms=b_ms,
                bound_by=b_by, live_bound_ms=live_ms)


def phase_main_moe() -> dict:
    """main-moe: qwen3-moe-235b-a22b at full width cut to MOE_LAYERS layers,
    main's mix through :func:`mono_then_disagg` (streams equal, telemetry
    exact); its decode step against the bytes bound; peak memory, tok/s
    and the launcher's ``[serve] moe:`` numbers.  Returns B1's and B2's
    launches in the monolithic run and the step's times."""
    args = launch_serve.parse_args(["--arch", MOE_ARCH] + MAIN_ARGS[2:])
    cfg = get_config(MOE_ARCH).replace(n_layers=MOE_LAYERS)
    model, params, init_s, base = init_model(cfg)
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    runs = mono_then_disagg("main-moe", model, params, args, base)
    log_runs("main-moe", cfg, runs, f" (cut from "
             f"{get_config(MOE_ARCH).n_layers} layers)")
    t0 = time.perf_counter()
    phase_mesh("main-moe-mesh", model, params, args, base,
               runs["monolithic"], (1, 1), ("expert", "model"))
    mesh_s = time.perf_counter() - t0
    s = runs["monolithic"]["stats"]
    log(f"main-moe: {weights} B of weights (initialised in {init_s:.2f}s); "
        f"[serve] moe: routed={s['moe_tokens_routed']} "
        f"dropped={s['moe_dropped_tokens']} "
        f"rank_imbalance={s['expert_imbalance']:.2f} "
        f"placements={s['placement_updates']}; experts with no token over "
        f"the run: {int((np.asarray(s['expert_tokens']) == 0).sum())} of "
        f"{cfg.n_experts}; disaggregated streams equal the monolithic ones")
    with ServeEngine(model, params, **engine_kw(args)) as eng:
        step = phase_step_moe("main-moe", model, params, eng)
    del params
    return {"counts": runs["monolithic"]["counts"], "step": step,
            "roles": runs["disagg"]["roles"], "mesh_s": mesh_s}


def phase_main_moe_placed() -> dict:
    """main-moe-placed: qwen3-moe at full width cut to MOE_PLACED_LAYERS
    layers, main's mix unplaced, then with the experts re-placed every
    MOE_PLACE_EVERY ticks: the streams equal bit for bit, at least one
    placement, ``phys_expert`` a permutation of the experts, the telemetry
    equal; the placed run again through an (expert 1, model 1) mesh of one
    NCCL rank, whose re-placements gather each layer's shards
    (:func:`phase_mesh`).  Between them the dense per-slot path (``paged=False``) on the
    same weights: flash attention at 64/4 heads on the tensor cores, L a
    prefill; its streams' agreement with the paged ones printed.  Returns
    the dense run's launches."""
    args = launch_serve.parse_args(["--arch", MOE_ARCH] + MAIN_ARGS[2:])
    cfg = get_config(MOE_ARCH).replace(n_layers=MOE_PLACED_LAYERS)
    model, params, _, base = init_model(cfg)
    prompts = launch_serve.make_prompts(args, cfg.vocab)
    runs = {}
    for run, kw in (("unplaced", {}), ("dense", {"paged": False}),
                    ("placed", {"placement_interval": MOE_PLACE_EVERY})):
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counts()
        t0 = time.perf_counter()
        with ServeEngine(model, params, **engine_kw(args), **kw) as eng:
            streams, counts, _, peak, rows = serve_counted(eng, prompts,
                                                           args.max_new)
            runs[run] = dict(streams=streams, counts=counts, rows=rows,
                             peak=peak - base,
                             stats=dict(eng.stats),
                             wall=time.perf_counter() - t0,
                             plan=eng.placement)
        if run != "dense":
            check_served(eng, f"main-moe-placed {run}", counts,
                         PAGED_KERNELS)
            check_moe_telemetry(f"main-moe-placed {run}", cfg,
                                {run: eng}, rows)
        del eng
    un, de, pl = runs["unplaced"], runs["dense"], runs["placed"]
    if pl["streams"] != un["streams"]:
        raise AssertionError("main-moe-placed: placed streams differ from the "
                             "unplaced ones")
    plan = pl["plan"]
    if (pl["stats"]["placement_updates"] < 1 or plan is None
            or sorted(plan.phys_expert.tolist()) != list(range(cfg.n_experts))):
        raise AssertionError(f"main-moe-placed: {pl['stats']['placement_updates']}"
                             " placements, or the plan is not a permutation")
    for k in ("moe_tokens_routed", "moe_dropped_tokens", "expert_tokens"):
        if pl["stats"][k] != un["stats"][k]:
            raise AssertionError(f"main-moe-placed: {k} differs placed vs "
                                 "unplaced")
    n_pre = de["stats"]["prefills"]
    L = cfg.n_layers
    dc = de["counts"]
    if (len(de["streams"]) != 8 or n_pre != 8
            or dc["flash_attention"] != (L * n_pre, 0)
            or dc["flash_attention_tc"] != (L * n_pre, 0)
            or any(p for _, p in dc.values())
            or any(k for name, (k, _) in dc.items()
                   if name not in ("flash_attention", "flash_attention_tc",
                                   "rmsnorm", "rmsnorm_add"))):
        raise AssertionError(f"main-moe-placed dense: {n_pre} prefills, "
                             f"launches {dc}")
    check_norm_counts("main-moe-placed dense", dc,
                      n_pre + de["stats"]["ticks"], qwen_norms(cfg))
    same = sum(a == b for rid in de["streams"]
               for a, b in zip(de["streams"][rid], un["streams"][rid]))
    toks = sum(len(o) for o in un["streams"].values())
    log(f"main-moe-placed: qwen3-moe {L} layers (cut from "
        f"{get_config(MOE_ARCH).n_layers}), experts re-placed every "
        f"{MOE_PLACE_EVERY} ticks: {pl['stats']['placement_updates']} "
        f"placements, streams equal to the unplaced run's bit for bit, "
        f"telemetry equal (routed {un['stats']['moe_tokens_routed']}, "
        f"dropped {un['stats']['moe_dropped_tokens']}), imbalance over the "
        f"last window {pl['stats']['expert_imbalance']:.2f}; wall unplaced "
        f"{un['wall']:.2f} s, placed {pl['wall']:.2f} s; peak unplaced "
        f"{un['peak']} B, placed {pl['peak']} B (the pristine tree and one "
        f"placed copy); the last plan's first slots "
        f"{plan.phys_expert[:8].tolist()}")
    log(f"main-moe-placed dense path: {n_pre} whole-prompt prefills (bucket "
        f"512), {de['stats']['ticks']} decode steps, {de['wall']:.2f} s, "
        f"launches {dc}; dense vs paged greedy streams {same}/{toks} tokens "
        f"equal (the chunked and whole-prompt prefills route other row "
        f"sets, so capacity drops differ)")
    t0 = time.perf_counter()
    phase_mesh("main-moe-placed-mesh", model, params, args, base, pl, (1, 1),
               ("expert", "model"), placement_interval=MOE_PLACE_EVERY,
               steps=False)
    del params
    return {"dense_counts": dc, "mesh_s": time.perf_counter() - t0}


def phase_main_arctic() -> dict:
    """main-arctic: arctic-480b at full width cut to ARCTIC_LAYERS layers,
    main's 8 requests (4 would all be admitted at once, and no prefix-cache
    hit would be gated) through :func:`mono_then_disagg`; its decode step
    against the bytes bound."""
    args = launch_serve.parse_args(["--arch", ARCTIC_ARCH] + MAIN_ARGS[2:])
    cfg = get_config(ARCTIC_ARCH).replace(n_layers=ARCTIC_LAYERS)
    model, params, init_s, base = init_model(cfg)
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    runs = mono_then_disagg("main-arctic", model, params, args, base)
    log_runs("main-arctic", cfg, runs, f" (cut from "
             f"{get_config(ARCTIC_ARCH).n_layers} layers)")
    log(f"main-arctic: {weights} B of weights (initialised in "
        f"{init_s:.2f}s); disaggregated streams equal the monolithic ones")
    with ServeEngine(model, params, **engine_kw(args)) as eng:
        step = phase_step_moe("main-arctic", model, params, eng)
    del params
    return {"counts": runs["monolithic"]["counts"], "step": step}


def phase_moe_block(dev) -> dict:
    """One full-width qwen3-moe layer's ``moe_apply`` on MOE_BLOCK_TOKENS
    tokens with bf16 weights and input, against the same call with the
    weights and input upcast to float32 on the card (float32 GEMMs, no
    TF32): both route through the same float32 router on the same values,
    so the telemetry must be equal and the outputs within MOE_BLOCK_REL
    (relative L2).  Prints the gap, and both calls' device times."""
    from repro_torch.models import moe as M
    from repro_torch.models.module import init_params
    cfg = get_config(MOE_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    p16 = init_params(M.moe_def(cfg), gen, device=dev, dtype=torch.bfloat16)
    p32 = {k: v.float() for k, v in p16.items()}
    x16 = torch.randn(1, MOE_BLOCK_TOKENS, cfg.d_model, generator=gen,
                      device=dev).to(torch.bfloat16)
    x32 = x16.float()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("moe-block: TF32 matmuls are on")
    serial = comm_lib.SerialComm()
    y16, _, s16 = M.moe_apply_expert_parallel(p16, x16, cfg, serial)
    y32, _, s32 = M.moe_apply_expert_parallel(p32, x32, cfg, serial)
    torch.cuda.synchronize()
    for k in ("tokens", "dropped"):
        if not torch.equal(s16[k], s32[k]):
            raise AssertionError(f"moe-block: {k} differ bf16 vs float32")
    rel = ((y16.float() - y32).norm() / y32.norm()).item()
    err = (y16.float() - y32).abs().max().item()
    if not rel <= MOE_BLOCK_REL:
        raise AssertionError(f"moe-block: bf16 vs float32 relative L2 gap "
                             f"{rel} > {MOE_BLOCK_REL}")
    t16 = device_ms([lambda: M.moe_apply(p16, x16, cfg)], reps=5)
    t32 = device_ms([lambda: M.moe_apply(p32, x32, cfg)], reps=5)
    log(f"moe-block: qwen3-moe layer (E {cfg.n_experts}, top_k {cfg.top_k}, "
        f"d {cfg.d_model}, expert d_ff {cfg.expert_d_ff}) on "
        f"{MOE_BLOCK_TOKENS} tokens, bf16 vs float32 weights: relative L2 "
        f"{rel:.3e} (gate {MOE_BLOCK_REL}), max |d| {err:.3e} (max |y| "
        f"{y32.abs().max().item():.3e}); routed {int(s16['tokens'].sum())}, "
        f"dropped {int(s16['dropped'].sum())} in both; device bf16 "
        f"{t16:.3f} ms, float32 {t32:.3f} ms")
    return {"rel": rel, "max_abs": err}


# -- the paper's science layer: the executor runtime and the three apps -------

def science_start() -> tuple[float, int]:
    """A science run's start: the clock, and the device memory already
    allocated (by earlier phases), from which its peak is counted."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return time.perf_counter(), torch.cuda.memory_allocated()


def science_report(label: str, start: tuple[float, int]) -> str:
    """Wall seconds since ``start`` (after a sync) and the run's own peak
    device memory (above what was allocated at its start)."""
    torch.cuda.synchronize()
    t0, base = start
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    return (f"{label} wall {time.perf_counter() - t0:.3f} s, peak device "
            f"memory {peak:.3f} GiB")


def step_times(fn, draws) -> str:
    """One step of an app's loop (``fn``, sync-free), host-issued and as
    device time, beside the device time of its threefry draws (``draws``,
    one call at the step's shapes)."""
    host = time_ms(fn, iters=10, warmup=2)
    devt = device_ms([fn], reps=10)
    rng_ms = device_ms([draws], reps=10)
    return (f"a step host-issued {host:.3f} ms, device {devt:.3f} ms (card "
            f"idle {max(0.0, 1 - devt / host):.1%}); its threefry draws "
            f"{rng_ms:.3f} ms device ({rng_ms / devt:.1%} of the step)")


def _runtime_rank(comm, dev):
    return apps_launch.quickstart(dev, comm, workers=SCI_FARM_WORKERS,
                                  deadline_factor=SCI_DEADLINE)


def phase_science_runtime(dev) -> None:
    """The paper's parabola (32 x 32 combinations) through the serial host
    loop, SerialExecutor, VmapExecutor, MeshExecutor over a real NCCL
    group at world 1, and the thread farm (8 workers, deadline factor 3):
    the counts equal, each executor's outputs within 1e-5 of the serial
    executor's; the farm's steals, rebalances and stragglers printed."""
    t0 = science_start()
    out = comm_lib.run_ranks(_runtime_rank, (dev,), world=1,
                             store_dir=STORE_DIR, device=dev)[0]
    if torch.distributed.is_initialized():
        raise AssertionError("science-runtime: a process group was left")
    log(f"science-runtime: parabola {apps_launch.M}x{apps_launch.M} "
        f"through serial, vmap, mesh (NCCL, world 1) and thread farm "
        f"({SCI_FARM_WORKERS} workers, deadline factor {SCI_DEADLINE}): "
        f"counts {out['counts']}, largest gap to serial {out['gap']:.3g}; "
        f"farm steals {out['farm']['steals']}, rebalances "
        f"{out['farm']['rebalances']}, stragglers "
        f"{out['farm']['stragglers']}; "
        + science_report("phase", t0))


def phase_science_mcmc(dev) -> None:
    """Ideal-point MCMC at the scale of a European Parliament term: the
    chains of the reference's defaults through VmapExecutor; recovery of
    the true ideal points gated, the largest R-hat printed; one vmapped
    Gibbs iteration timed beside its threefry draws; then a small chain
    on the card against the same chain on the CPU."""
    n_leg, n_votes = SCI_MCMC
    t0 = science_start()
    y, truth = mcmc.make_synthetic_votes(prng.PRNGKey(1), n_leg, n_votes,
                                         device=dev)
    problem = mcmc.IdealPointProblem(y, n_chains=4, n_iter=200, burn=100)
    res = mcmc.solve(problem, "vmap")
    corr = abs(float(np.corrcoef(res["x_mean"].cpu().numpy(),
                                 truth["x"].cpu().numpy())[0, 1]))
    rhat = float(res["rhat"].max())
    wall = science_report("", t0)
    if not corr > 0.95 or not np.isfinite(rhat):
        raise AssertionError(f"science-mcmc: |corr| {corr}, max R-hat {rhat}")
    keys = problem.initialize()["key"]
    pos = y > 0.5
    carry = (torch.zeros(4, n_leg, device=dev),
             torch.zeros(4, n_votes, device=dev),
             torch.zeros(4, n_votes, device=dev))
    step = torch.func.vmap(lambda k, x, b, a: mcmc.gibbs_step(
        (x, b, a), k, pos), randomness="error")
    draws = torch.func.vmap(lambda k: (
        prng.uniform(k, (n_leg, n_votes), minval=1e-6, maxval=1 - 1e-6),
        prng.normal(k, (2, n_votes)), prng.normal(k, (n_leg,))),
        randomness="error")
    times = step_times(lambda: step(keys, *carry), lambda: draws(keys))
    # the same small chain on the card and on the CPU (the CPU test's
    # limit against the reference, 1e-3)
    ys, _ = mcmc.make_synthetic_votes(prng.PRNGKey(2), 20, 40, device="cpu")
    chains = [mcmc.run_chain(prng.PRNGKey(3, device=d), ys.to(d), n_iter=40,
                             burn=0, thin=1)["x_draws"].cpu()
              for d in (dev, "cpu")]
    gap = float((chains[0] - chains[1]).abs().max())
    if not gap < 1e-3:
        raise AssertionError(f"science-mcmc: card chain != CPU chain ({gap})")
    log(f"science-mcmc: {n_leg} members x {n_votes} roll calls (seed 1), 4 "
        f"chains x 200 iterations (burn 100) through VmapExecutor: "
        f"|corr(x_mean, true x)| {corr:.4f} (gate > 0.95), largest R-hat "
        f"{rhat:.4f};{wall}; {times}; a 20 x 40 chain of 40 iterations: "
        f"card vs CPU max |dx| {gap:.3g} (limit 1e-3)")


def phase_science_dmc(dev) -> None:
    """DMC in a 3D harmonic trap: the serial driver, the load-balanced SPMD
    driver over a real NCCL group at world 1, and independent replicas on
    the thread farm; every E0 estimate within 0.1 of 1.5, no population
    extinct or at its capacity.  One walker step timed beside its threefry
    draws."""
    n, cap, steps = SCI_DMC_SERIAL
    lines = []

    def gate(label, out, capacity):
        """E0 within 0.1 of 1.5; the population never extinct nor at its
        capacity (replicas: each replica's)."""
        runs = out.get("replicas", [out])
        e0s = [float(r["e0_estimate"]) for r in runs]
        counts = np.concatenate([r["counts"].cpu().numpy() for r in runs])
        if (not all(abs(e - 1.5) < 0.1 for e in e0s) or counts.min() <= 0
                or counts.max() >= capacity):
            raise AssertionError(f"science-dmc {label}: E0 {e0s}, population "
                                 f"{counts.min()}..{counts.max()} of "
                                 f"{capacity}")
        return (f"E0 {' / '.join(f'{e:.4f}' for e in e0s)}, population "
                f"{counts.min()}..{counts.max()}")

    t0 = science_start()
    out = dmc.run_serial(n, steps, capacity=cap, tau=0.01, device=dev)
    lines.append(f"run_serial {n} walkers (capacity {cap}), tau 0.01, "
                 f"{steps} steps: {gate('serial', out, cap)};"
                 + science_report("", t0))
    n_p, steps_p = SCI_DMC_PARALLEL
    t0 = science_start()
    out = dmc.run_parallel(n_p, steps_p, world=1, store_dir=STORE_DIR,
                           tau=0.01, device=dev)
    lines.append(f"run_parallel (NCCL, world 1) {n_p} walkers (capacity "
                 f"{4 * n_p}), {steps_p} steps: "
                 f"{gate('parallel', out, 4 * n_p)}, rebalances "
                 f"{out['rebalances']};" + science_report("", t0))
    reps, n_r, steps_r = SCI_DMC_REPLICAS
    t0 = science_start()
    out = dmc.run_replicas(reps, "thread", n_r, steps_r, tau=0.01,
                           device=dev, num_workers=reps)
    lines.append(f"run_replicas on the thread farm, {reps} x {n_r} walkers, "
                 f"{steps_r} steps: {gate('replicas', out, 4 * n_r)}, mean "
                 f"{float(out['e0_estimate']):.4f} spread "
                 f"{float(out['e0_std']):.4f};" + science_report("", t0))
    # the same replicas one after another: the farm's yardstick; each
    # replica's arithmetic is the same either way
    t0 = science_start()
    ref = dmc.run_replicas(reps, "serial", n_r, steps_r, tau=0.01,
                           device=dev)
    e0s = [float(r["e0_estimate"]) for r in out["replicas"]]
    if e0s != [float(r["e0_estimate"]) for r in ref["replicas"]]:
        raise AssertionError("science-dmc: farm replicas != serial replicas")
    lines.append("the same replicas on SerialExecutor: E0 equal;"
                 + science_report("", t0))
    w = dmc.Walkers(n, cap, tau=0.01, device=dev)
    k = prng.PRNGKey(9)
    times = step_times(
        lambda: dmc.walker_step(k, w.pos, w.count, w.e_trial, tau=0.01),
        lambda: (prng.normal(k, (cap, 3), device=dev),
                 prng.uniform(k, (cap,), device=dev)))
    log("science-dmc: " + "; ".join(lines) + f"; walker step at capacity "
        f"{cap}: {times}")
    if torch.distributed.is_initialized():
        raise AssertionError("science-dmc: a process group was left")


def phase_science_boussinesq(dev) -> None:
    """Boussinesq waves on a 2048 x 2048 grid, serial and through the
    Schwarz route over a real NCCL group at world 1: relative mass drift
    under 1e-5, the two routes within 1e-5 of each other, every step's
    iterations within the cap; one Jacobi iteration timed; then 48 x 48 on
    the card against the CPU within 1e-5."""
    nx, steps = SCI_BQ
    p = bq.BoussinesqParams(nx=nx, ny=nx, dx=0.1, dt=0.02, eps=0.3,
                            alpha=0.05)
    t0 = science_start()
    eta_s, phi_s, hist_s = bq.run_serial(p, steps, device=dev)
    serial = science_report("", t0)
    t0 = science_start()
    eta_p, phi_p, hist_p = bq.run_parallel(p, steps, world=1,
                                           store_dir=STORE_DIR, device=dev)
    schwarz = science_report("", t0)
    mass = hist_s["mass"].double().cpu()
    # relative to the wave's mass of |eta| (its signed mass is ~0)
    scale = float(eta_s.abs().sum())
    drift = float((mass - mass[0]).abs().max()) / scale
    gap = max(float((eta_s.cpu() - eta_p).abs().max()),
              float((phi_s.cpu() - phi_p).abs().max()))
    iters = hist_s["iters"] + hist_p["iters"]
    if (not drift < 1e-5 or not gap < 1e-5
            or not all(1 <= i < p.schwarz_max_iter for i in iters)):
        raise AssertionError(f"science-boussinesq: drift {drift}, gap {gap}, "
                             f"iterations {min(iters)}..{max(iters)}")
    eta, phi = bq.initial_condition(p, device=dev)
    eta, phi = bq._with_ghosts(eta), bq._with_ghosts(phi)
    rhs = torch.zeros_like(eta[1:-1]) + 1e-3

    def iteration():
        d = bq.apply_physical_bc(phi, None)
        d = bq.jacobi_sweeps(d, rhs, p.c, p.dx, p.jacobi_sweeps)
        return torch.sum((d - phi) ** 2) / torch.sum(d ** 2)

    host = time_ms(iteration, iters=10, warmup=2)
    devt = device_ms([iteration], reps=10)
    small = bq.BoussinesqParams(nx=48, ny=48, dt=0.02, eps=0.3, alpha=0.05)
    card, cpu = (bq.run_serial(small, 30, device=d) for d in (dev, "cpu"))
    small_gap = max(float((card[i].cpu() - cpu[i]).abs().max())
                    for i in (0, 1))
    if not small_gap < 1e-5 or card[2]["iters"] != cpu[2]["iters"]:
        raise AssertionError(f"science-boussinesq: 48x48 card != CPU "
                             f"({small_gap})")
    log(f"science-boussinesq: {nx} x {nx} (dx 0.1, dt 0.02, eps 0.3, alpha "
        f"0.05), {steps} steps: serial Jacobi iterations a step "
        f"{min(hist_s['iters'])}..{max(hist_s['iters'])} (mean "
        f"{np.mean(hist_s['iters']):.1f}, {sum(hist_s['iters'])} in all, one "
        f"host read each but the first),{serial}; Schwarz (NCCL, world 1) "
        f"iterations {min(hist_p['iters'])}..{max(hist_p['iters'])} (mean "
        f"{np.mean(hist_p['iters']):.1f}, one max all-reduce and host read "
        f"each),{schwarz}; relative mass drift {drift:.3g} (gate 1e-5), "
        f"serial vs Schwarz max gap {gap:.3g} (gate 1e-5); one iteration "
        f"({p.jacobi_sweeps} sweeps and the convergence sums) host-issued "
        f"{host:.3f} ms, device {devt:.3f} ms (card idle "
        f"{max(0.0, 1 - devt / host):.1%}); 48 x 48, 30 steps: card vs CPU "
        f"max gap {small_gap:.3g}, iterations equal")
    if torch.distributed.is_initialized():
        raise AssertionError("science-boussinesq: a process group was left")



# -- multimodal serving (ROADMAP A10): llava's image prefixes, whisper -------

# main-vlm: llava-next-mistral-7b at full width and depth (32 layers, d
# 4096, 32/8 heads of 128, d_ff 14336, 2880 image tokens), each request
# with one of two alternating images; max_len 3008 (188 pages of 16) holds
# the image, a 16-token shared prefix (one page), a tail of up to 47 tokens
# and 32 new ones
VLM_ARGS = ["--arch", "llava-next-mistral-7b", "--image", "--requests", "8",
            "--max-new", "32", "--slots", "4", "--max-len", "3008",
            "--page-size", str(PS), "--prefill-chunk", "64",
            "--prefix-cache", "on", "--shared-prefix", "16", "--device",
            "cuda"]
# main-whisper: whisper-tiny at full width (4 + 4 layers, d 384, 6 heads of
# 64, 1500 frames, vocab 51865), every request with one of two clips: 24
# encode chunks a clip (23 of 64 frames, one of 32 with 28 valid)
WHISPER_ARGS = ["--arch", "whisper-tiny", "--audio", "--requests", "8",
                "--max-new", "32", "--slots", "4", "--max-len", "128",
                "--page-size", str(PS), "--prefill-chunk", "64",
                "--shared-prefix", "16", "--device", "cuda"]
WHISPER_CHUNKS = 24
# the timed steps (4 slots' lengths, the 64-row chunk's start): llava's
# decode ~2950 deep and its last image chunk; whisper's decode and its
# first decoder chunk
VLM_STEP = ((2950, 2941, 2962, 2933), 2816)
WHISPER_STEP = ((80, 66, 93, 70), 0)
# B3 at the multimodal shapes, bf16 on the tensor cores: (B, Sq, Sk, Hq,
# Hkv, D, causal): whisper's encode chunk, a clip's last chunk (32 frames
# of the clip padded to 1504, its keys cut to the 28 valid), a full chunk's
# keys cut to 28 and to 1, a whole 1500-frame clip, llava's dense prefill
# (the image and a 64-token text), and qwen3-moe's G 16 at bucket 512
# (main-moe-placed)
MM_FLASH = {"whisper-chunk": (1, 64, 64, 6, 6, 64, False),
            "whisper-last-chunk": (1, 32, 28, 6, 6, 64, False),
            "whisper-chunk-k28": (1, 64, 28, 6, 6, 64, False),
            "whisper-chunk-k1": (1, 64, 1, 6, 6, 64, False),
            "whisper-clip": (1, 1500, 1500, 6, 6, 64, False),
            "llava-prefill": (1, 2944, 2944, 32, 8, 128, True),
            "g16-prefill": (1, 512, 512, 64, 4, 128, True)}
# B1 at the multimodal shapes: (B, W, Hq, Hkv, D, table pages, pool pages,
# lengths, layers timed): whisper's decoder (G 1, D 64) at decode, at
# ngram speculation's verify windows of 3 and 5 (main-whisper's widths)
# and at a 64-row chunk; llava's last image chunk (2880 deep) and a decode
# ~2950 deep over tables of 188 pages (47 key ranges)
MM_PAGED = {"whisper-decode": (4, 1, 6, 6, 64, 8, 40, (80, 66, 93, 0), 4),
            "whisper-verify-w3": (4, 3, 6, 6, 64, 8, 40, (45, 38, 57, 62),
                                  4),
            "whisper-verify-w5": (4, 5, 6, 6, 64, 8, 40, (45, 38, 57, 0), 4),
            "whisper-chunk": (1, 64, 6, 6, 64, 8, 40, (1,), 4),
            "llava-chunk": (1, 64, 32, 8, 128, 188, 200, (2817,), 32),
            "llava-decode": (4, 1, 32, 8, 128, 188, 760,
                             (2950, 2941, 2962, 2933), 32)}


class KernelShapes:
    """From construction to :meth:`stop`, the calls through ``ops`` of B3,
    B1 and B2 (the norm and its fused add), counted by shape: B3 (B, Sq,
    Sk, Hq, Hkv, D, causal, window, dtype, grad), B1 (B, W, Hq, Hkv, D,
    table pages, q dtype, page dtype), B2 (variant, rows, d, dtype, scale
    dtype, keep_sum, eps, grad); ``grad`` says autograd took a gradient
    through the call.  :meth:`parity` holds each kernel against its plain
    version at each shape, and under ``grad`` its backward kernel against
    autograd through the plain version too."""

    def __init__(self):
        self.flash, self.paged, self.norm = (collections.Counter()
                                             for _ in range(3))
        self._lock = threading.Lock()
        self._ops = {name: getattr(ops, name) for name in (
            "flash_attention", "paged_attention_mq", "rmsnorm",
            "add_rmsnorm")}
        fa, pa, rn, arn = self._ops.values()

        def tally(counter, key):
            with self._lock:
                counter[key] += 1

        def flash(q, k, v, *, causal=True, window=None, q_offset=0):
            tally(self.flash, (*q.shape[:2], k.shape[1], q.shape[2],
                               k.shape[2], q.shape[3], causal, window,
                               q.dtype, ops._needs_grad(q, k, v), q_offset))
            return fa(q, k, v, causal=causal, window=window,
                      q_offset=q_offset)

        def paged(q, k_pages, v_pages, tables, lengths, k_scale=None,
                  v_scale=None):
            tally(self.paged, (*q.shape[:3], k_pages.shape[2], q.shape[3],
                               tables.shape[-1], q.dtype, k_pages.dtype))
            return pa(q, k_pages, v_pages, tables, lengths, k_scale, v_scale)

        def rmsnorm(x, scale, *, eps=1e-6):
            tally(self.norm, ("rmsnorm", x.numel() // x.shape[-1],
                              x.shape[-1], x.dtype, scale.dtype, True, eps,
                              ops._needs_grad(x, scale)))
            return rn(x, scale, eps=eps)

        def add_rmsnorm(x, delta, scale, *, eps=1e-6, keep_sum=True):
            tally(self.norm, ("add_rmsnorm", x.numel() // x.shape[-1],
                              x.shape[-1], x.dtype, scale.dtype, keep_sum,
                              eps, ops._needs_grad(x, delta, scale)))
            return arn(x, delta, scale, eps=eps, keep_sum=keep_sum)

        for name, fn in zip(self._ops, (flash, paged, rmsnorm, add_rmsnorm)):
            setattr(ops, name, fn)

    def stop(self):
        for name, fn in self._ops.items():
            setattr(ops, name, fn)

    def flash_calls(self, windowed: bool) -> int:
        """B3 calls with a window (``windowed``) or without."""
        return sum(n for key, n in self.flash.items()
                   if (key[7] is not None) == windowed)

    def parity(self, label, dev) -> dict:
        """Each recorded shape on seeded random inputs, kernel against plain
        version under TOL (B1: each slot's length random over its table, so
        windows run up to the table's end; B2: the fused add's sum bit for
        bit), and under ``grad`` the backward kernel against autograd
        through the plain version in float32 (:func:`flash_bwd_gap`,
        :func:`norm_bwd_gap`): max abs error by kernel name, and a line."""
        rng = np.random.default_rng(5)
        errs = {}

        def keep(name, e):
            errs[name] = max(errs.get(name, 0.0), e)

        for B, Sq, Sk, Hq, Hkv, D, causal, window, dt, grad, off in sorted(
                self.flash, key=str):
            q = torch.randn(B, Sq, Hq, D, device=dev).to(dt)
            k, v = (torch.randn(B, Sk, Hkv, D, device=dev).to(dt)
                    for _ in range(2))
            what = (f"{label} path shape B={B} Sq={Sq} Sk={Sk} Hq={Hq} "
                    f"Hkv={Hkv} D={D} causal={causal} window={window} "
                    f"q_offset={off} {dt}")
            kw = dict(causal=causal, window=window, q_offset=off)
            keep("flash_attention", check(
                "flash_attention", what, ops.flash_attention(q, k, v, **kw),
                ref.flash_attention(q, k, v, **kw), dt))
            del q, k, v
            if grad:
                keep("flash_attention_bwd", flash_bwd_gap(
                    dev, B, Sq, Hq, Hkv, D, causal, window, dt, what,
                    Sk=Sk, q_offset=off)[0])
        for B, W, Hq, Hkv, D, P, qdt, pdt in sorted(self.paged, key=str):
            lengths = rng.integers(1, P * PS - W + 2, B)
            q, kp, vp, tb, ln = mm_paged_case(rng, dev, B, W, Hq, Hkv, D, P,
                                              B * P, lengths)
            if pdt == torch.int8:
                name, args = "paged_attention_mq_int8", (
                    *quantize_pages(kp, vp)[:2], tb, ln,
                    *quantize_pages(kp, vp)[2:])
            else:
                name, args = "paged_attention_mq", (kp.to(pdt), vp.to(pdt),
                                                    tb, ln)
            keep(name, check(name, f"{label} path shape B={B} W={W} Hq={Hq} "
                             f"Hkv={Hkv} D={D} P={P} {qdt} pages {pdt}",
                             ops.paged_attention_mq(q.to(qdt), *args),
                             ref.paged_attention_mq(q.to(qdt), *args), qdt))
        for variant, rows, d, dt, sdt, keep_sum, eps, grad in sorted(
                self.norm, key=str):
            x, dl = (torch.randn(rows, d, device=dev).to(dt) for _ in range(2))
            scale = (1 + 0.1 * torch.randn(d, device=dev)).to(sdt)
            what = (f"{label} path shape {variant} rows={rows} d={d} {dt} "
                    f"scale {sdt} keep_sum={keep_sum} eps={eps}")
            if variant == "rmsnorm":
                got = ops.rmsnorm(x, scale, eps=eps)
                want = ref.rmsnorm(x, scale, eps=eps)
            else:
                (s, got), (s_want, want) = (fn(
                    x, dl, scale, eps=eps, keep_sum=keep_sum)
                    for fn in (ops.add_rmsnorm, ref.add_rmsnorm))
                if keep_sum and not torch.equal(s, s_want):
                    raise AssertionError(f"add_rmsnorm {what}: s is not x "
                                         "+ delta bit for bit")
            keep("rmsnorm", check("rmsnorm", what, got, want, dt))
            del x, dl
            if grad:
                keep("rmsnorm_bwd", norm_bwd_gap(
                    dev, variant, rows, d, dt, keep_sum, what, sdt, eps)[0])
        log(f"{label}: every B3, B1 and B2 shape of its calls held against "
            f"the plain version (under grad the backward too), with its "
            f"calls: B3 {sorted(self.flash.items(), key=str)}; B1 "
            f"{sorted(self.paged.items(), key=str)}; B2 "
            f"{sorted(self.norm.items(), key=str)}; max abs err {errs}")
        return errs


def serve_margins(eng, reqs, max_new: int):
    """Serve ``reqs`` ((prompt, payload) each) on ``eng`` with a margin
    recorder each: (streams by submission index, their margins)."""
    samplers, rids = [], []
    for prompt, payload in reqs:
        samplers.append(MarginSampler(eng.model.cfg.vocab))
        rids.append(eng.submit(prompt, max_new_tokens=max_new,
                               encoder_input=payload, sampler=samplers[-1]))
    done = {r.rid: r for r in eng.run_until_drained()}
    if any(done[rid].error is not None for rid in rids):
        raise AssertionError([done[rid].error for rid in rids])
    return ({i: done[rid].output for i, rid in enumerate(rids)},
            {i: s.margins for i, s in enumerate(samplers)})


def serve_mm(args_list, label: str):
    """The launcher on ``args_list`` with the counts and the peak mark
    zeroed first: (engine, counts, wall seconds, peak device bytes)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    eng = launch_serve.main(args_list)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: (c.kernel, c.plain) for k, c in ops.COUNTS.items()}
    done = eng.finished
    if len(done) != 8 or any(r.error is not None for r in done) or any(
            len(r.output) != 32 or not all(0 <= t < eng.model.cfg.vocab
                                           for t in r.output) for r in done):
        raise AssertionError(f"{label}: {len(done)} finished, errors "
                             f"{[r.error for r in done if r.error]}")
    for name, (_, plain) in counts.items():
        if plain:
            raise AssertionError(f"{label}: {name}'s plain version ran "
                                 f"{plain} times")
    return eng, counts, wall, torch.cuda.max_memory_allocated()


def identical_pair(eng, label, args, enc_shape,
                   against_run: bool = True) -> str:
    """The launcher's first request (its prompt and payload) twice at once
    on ``eng`` after its run: the two streams under :func:`stream_gate`,
    and with ``against_run`` the launcher run's own stream against the
    first of them, gated the same way."""
    prompt, payload = launch_serve.make_requests(
        args, eng.model.cfg.vocab, enc_shape)[0]
    first = min(eng.finished, key=lambda r: r.rid).output
    streams, margins = serve_margins(eng, [(prompt, payload)] * 2,
                                     args.max_new)
    pair = stream_gate(label, {1: streams[1]}, {1: streams[0]},
                       {1: margins[0]})
    line = f"identical pair {pair[0]}"
    if against_run:
        again = stream_gate(f"{label} against the run's own", {0: first},
                            {0: streams[0]}, margins)
        line += f"; against the run's own {again[0]}"
    return line


def fresh_then_cached(model, params, args, prompt, payload) -> list:
    """``prompt`` with its image ``payload`` served alone on a new paged
    engine of ``args`` (its prefix cache empty), then again on it, from
    the cache: ``(stream, its sampler with each token's logits, prefix hit
    tokens)`` of each run."""
    runs = []
    with ServeEngine(model, params, **engine_kw(args)) as e:
        for _ in range(2):
            smp = MarginSampler(model.cfg.vocab, keep=True)
            hit = e.stats["prefix_hit_tokens"]
            rid = e.submit(prompt, max_new_tokens=args.max_new,
                           encoder_input=payload, sampler=smp)
            r = {r.rid: r for r in e.run_until_drained()}[rid]
            if r.error is not None:
                raise AssertionError(r.error)
            runs.append((r.output, smp, e.stats["prefix_hit_tokens"] - hit))
    return runs


def chunked_token0(model, params, storage, toks, payload, starts, P: int,
                   replay: bool = False):
    """Token 0's logits (float32, the true vocab) of a prefill run at model
    level as the engine runs it: a chunk from each of ``starts`` to the
    next (the last to the page-padded end), into pages 0.. of ``storage``
    (with ``replay``, as for a prompt found whole in the prefix cache, into
    its trash page ``P``) through a table of ``P`` pages, the rows of
    ``payload`` where ``toks`` are image pseudo-tokens."""
    dev = next(iter(tree_leaves(storage))).device
    total, padded = len(toks), -(-len(toks) // PS) * PS
    row = torch.arange(P, dtype=torch.int32, device=dev)
    bounds = list(starts) + [padded]
    for start, end in zip(bounds, bounds[1:]):
        C = end - start
        t = np.zeros(C, np.int32)
        valid = min(C, total - start)
        t[:valid] = toks[start:start + valid]
        kw = {}
        if start < len(payload):
            buf = np.zeros((C, payload.shape[1]), np.float32)
            take = min(C, len(payload) - start)
            buf[:take] = payload[start:start + take]
            kw["embeds"] = torch.tensor(buf[None], device=dev)
        pages = row[start // PS:end // PS].clone()
        if replay:
            pages.fill_(P)
        hidden, _ = model.paged_prefill_chunk(
            params, storage, row, pages, start,
            torch.tensor(t[None], device=dev), **kw)
    logits = model.lm_head(params, hidden[:, valid - 1:valid])
    return logits[0, -1, :model.cfg.vocab].float()


def prefix_cache_trace(eng, args) -> str:
    """The launcher's first image request fresh and from the prefix cache.
    A cached request prefills only the rows past its hit, in a chunk of
    another row count than the fresh prefill's last, so its GEMMs and B1
    round differently, and a random model at full depth amplifies that
    (see GATE_DEPTH).  Gated: the launcher run's stream equals the request
    served alone (near-tie rule); at full depth the engine's fresh and
    cached token-0 logits equal, bit for bit, a model-level prefill over
    fresh pages with the engine's chunks, so the cache hands back exactly
    a fresh prefill's K/V; at GATE_DEPTH layers, in the served dtype and
    in float32, fresh and cached streams under the near-tie rule, and in
    float32 their token-0 logits within CACHE_F32_TOL, while the cached
    chunk over the other image's pages (a wrong cache entry) must part
    by more.  Printed: the full-depth fresh against cached gap and
    streams, and the served dtype's gap at GATE_DEPTH."""
    cfg, model, dev = eng.model.cfg, eng.model, eng.device
    reqs = launch_serve.make_requests(args, cfg.vocab,
                                      launch_serve.encoder_shape(cfg, args))
    (prompt, payload), (_, other) = reqs[0], reqs[1]
    toks = np.concatenate([encoder_prefix_tokens(payload), prompt])
    total, P = len(toks), eng.sched.pages_per_slot
    padded = -(-total // PS) * PS
    fresh_starts = range(0, padded, args.prefill_chunk)
    # the fresh request's decode fills its prompt's last page, which it
    # registers, so its twin finds the whole prompt in the cache and
    # replays that page for token 0's logits (as the scheduler admits it)
    replay_starts = range((total - 1) // PS * PS, padded, args.prefill_chunk)
    first = min(eng.finished, key=lambda r: r.rid).output

    def pages():
        return PG.PagePool(model.paged_leaf_specs(None), num_pages=P,
                           page_size=PS, device=dev).storage

    def hits(label, f_hit, c_hit):
        if (f_hit, c_hit) != (0, total):
            raise AssertionError(f"{label}: prefix hits fresh {f_hit}, "
                                 f"cached {c_hit}, want 0 and {total}")

    (f_out, f_smp, f_hit), (c_out, c_smp, c_hit) = fresh_then_cached(
        model, eng.params, args, prompt, payload)
    hits("main-vlm", f_hit, c_hit)
    alone = stream_gate("main-vlm the run's first request against it served "
                        "alone", {0: first}, {0: f_out}, {0: f_smp.margins})
    storage = pages()
    fresh = chunked_token0(model, eng.params, storage, toks, payload,
                           fresh_starts, P)
    cached = chunked_token0(model, eng.params, storage, toks, payload,
                            replay_starts, P, replay=True)
    for what, got, want in (("fresh", f_smp.logits[0], fresh),
                            ("cached", c_smp.logits[0], cached)):
        if not torch.equal(got, want):
            raise AssertionError(
                f"main-vlm: the engine's {what} token-0 logits are "
                f"{(got - want).abs().max().item()} from the model-level "
                "prefill's over fresh pages (want bit-equal)")
    gap = (fresh - cached).abs().max().item()
    full = stream_gate("main-vlm", {0: c_out}, {0: f_out})
    del storage
    # GATE_DEPTH layers of the same weights, bf16 and float32, where
    # rounding is 2^16 times finer: the float32 twins agree within
    # CACHE_F32_TOL, and over the other image's pages (a wrong cache
    # entry) token 0 parts by more
    depth = {}
    for dt in dict.fromkeys((cfg.dtype, "float32")):
        cut = build_model(cfg.replace(n_layers=GATE_DEPTH, dtype=dt))
        cparams = dict(eng.params, blocks=tree_map(lambda a: a[:GATE_DEPTH],
                                                   eng.params["blocks"]))
        if dt != cfg.dtype:
            cparams = tree_map(lambda t: t.float(), cparams)
        (f2_out, f2_smp, f2_hit), (c2_out, c2_smp, c2_hit) = \
            fresh_then_cached(cut, cparams, args, prompt, payload)
        hits(f"main-vlm depth {GATE_DEPTH} {dt}", f2_hit, c2_hit)
        storage = PG.PagePool(cut.paged_leaf_specs(None), num_pages=P,
                              page_size=PS, device=dev).storage
        chunked_token0(cut, cparams, storage,
                       np.concatenate([encoder_prefix_tokens(other), prompt]),
                       other, fresh_starts, P)
        wrong = chunked_token0(cut, cparams, storage, toks, payload,
                               replay_starts, P, replay=True)
        depth[dt] = (
            (f2_smp.logits[0] - c2_smp.logits[0]).abs().max().item(),
            (wrong - f2_smp.logits[0]).abs().max().item(),
            stream_gate(f"main-vlm depth {GATE_DEPTH} {dt} cached against "
                        "fresh", {0: c2_out}, {0: f2_out},
                        {0: f2_smp.margins})[0])
        del cut, cparams, storage
    gap2, wrong2, _ = depth["float32"]
    if not gap2 <= CACHE_F32_TOL < wrong2:
        raise AssertionError(f"main-vlm depth {GATE_DEPTH} float32: cached "
                             f"against fresh token-0 max |d logit| {gap2}, "
                             f"over the other image's pages {wrong2}; want "
                             f"<= {CACHE_F32_TOL} and over it")
    return (f"prefix cache against a fresh prefill (hit {c_hit} of "
            f"{total} tokens; the replayed chunk {padded - replay_starts[0]} "
            f"rows, the fresh one's last {padded - fresh_starts[-1]}): the "
            f"run's first request against it served alone {alone[0]}; full "
            f"depth: engine fresh and cached token-0 logits == the "
            f"model-level prefills over fresh pages (bit for bit), fresh "
            f"against cached token-0 max |d logit| {gap:.4f} (printed, "
            f"chaotic at random init), streams {full[0]}; depth "
            f"{GATE_DEPTH}: " + "; ".join(
                f"{dt} token-0 max |d logit| {g:.3g}, over the other "
                f"image's pages {w:.4f}, streams {line}"
                for dt, (g, w, line) in depth.items())
            + f" (float32 gate {CACHE_F32_TOL})")


def mm_step(eng, label: str, lens, start: int, cross=None, embeds=False,
            encode=None) -> dict:
    """``eng``'s decode step (4 slots at ``lens``) and a 64-row prefill
    chunk at ``start`` (over an image prefix with ``embeds``), with the
    ``cross`` bundle of an enc-dec model, and ``encode`` (an encode chunk's
    call) beside them: host-issued and device time (a replayed CUDA graph)
    each, with the card's idle share."""
    model, params, storage = eng.model, eng.params, eng.pool.storage
    cfg, dev = model.cfg, eng.device
    rng = np.random.default_rng(3)
    B, P = eng.max_slots, eng.sched.pages_per_slot
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    tables = torch.tensor(np.stack([rng.permutation(eng.pool.num_pages)[:P]
                                    for _ in range(B)]).astype(np.int32),
                          device=dev)
    toks = torch.tensor(rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32),
                        device=dev)
    wp = tables[torch.arange(B, device=dev), (ln // PS).long()]
    wo = ln % PS
    row, C = tables[0], 64
    pages = row[start // PS:(start + C) // PS]
    ctoks = torch.tensor(rng.integers(0, cfg.vocab, (1, C)).astype(np.int32),
                         device=dev)
    kw, ckw = {}, {}
    if cross is not None:       # the decode bundle, and slot 0's for a chunk
        kw["cross"] = c = cross(B)
        ckw["cross"] = dict(c, tables=c["tables"][0],
                            frames_len=c["frames_len"][0])
    if embeds:                  # every row of the chunk an image row
        ctoks = torch.full((1, C), -1, dtype=torch.int32, device=dev)
        ckw["embeds"] = torch.randn(1, C, cfg.d_model, device=dev)
    fns = {f"decode step ({B} slots at {list(lens)})":
           lambda: model.paged_decode_step(params, storage, tables, ln, toks,
                                           wp, wo, **kw),
           f"prefill chunk ({C} rows at {start})":
           lambda: model.paged_prefill_chunk(params, storage, row, pages,
                                             start, ctoks, **ckw)}
    if encode is not None:
        fns["encode chunk (64 frames, encoder + cross K/V + scatter)"] = \
            encode
    out = {}
    for name, fn in fns.items():
        host = time_ms(fn, iters=10, warmup=2)
        devt = device_ms([fn], reps=10)
        out[name.split(" (")[0]] = {"host_ms": host, "device_ms": devt}
        log(f"{label} {name}: host-issued {host:.3f} ms, device {devt:.3f} "
            f"ms (card idle {max(0.0, 1 - devt / host):.1%} of the "
            f"host-issued time)")
    return out


def phase_main_vlm() -> dict:
    """main-vlm: llava-next-mistral-7b at full width and depth through the
    launcher's ``--image``: the 8 requests finish through the kernels (B1
    and B2 exactly L and 1 + 2L a step or chunk, every B1 call split), the
    exact prefix hits of the repeated images, the pool whole; then two
    identical image requests, and the decode step and an image chunk
    timed."""
    shapes = KernelShapes()             # every serving call's, to the trace
    eng, counts, wall, peak = serve_mm(VLM_ARGS, "main-vlm")
    args = launch_serve.parse_args(VLM_ARGS)
    cfg, s, pool = eng.model.cfg, eng.stats, eng.pool
    L, steps = cfg.n_layers, s["ticks"] + s["chunk_prefills"]
    check_norm_counts("main-vlm", counts, steps, qwen_norms(cfg))
    check_split("main-vlm", counts, "paged_attention_mq",
                eng.sched.pages_per_slot)
    if counts["paged_attention_mq"][0] != L * steps:
        raise AssertionError(f"main-vlm: B1 launched "
                             f"{counts['paged_attention_mq'][0]} times over "
                             f"{steps} steps and chunks, want {L} each")
    others = [k for k, (n, _) in counts.items() if n and k not in
              PAGED_KERNELS]
    if others:
        raise AssertionError(f"main-vlm: {others} launched")
    # the first 4 requests are admitted together (no page registered yet);
    # each later one finds its image's 180 pages and the shared prefix's
    # page in the cache
    hits = args.requests - args.slots
    per_hit = (cfg.n_image_tokens + args.shared_prefix) // PS * PS
    if (s["prefix_hits"], s["prefix_hit_tokens"]) != (hits, hits * per_hit):
        raise AssertionError(f"main-vlm: prefix hits {s['prefix_hits']} / "
                             f"{s['prefix_hit_tokens']} tokens, want {hits} "
                             f"/ {hits * per_hit}")
    if pool.pages_free + pool.pages_cached + pool.pages_in_use \
            != pool.num_pages:
        raise AssertionError("main-vlm: the page pool is not whole")
    toks = sum(len(r.output) for r in eng.finished)
    weights = sum(t.numel() * t.element_size()
                  for t in tree_leaves(eng.params))
    log(f"main-vlm: llava-next-mistral-7b {L} layers {cfg.dtype}, "
        f"{sum(t.numel() for t in tree_leaves(eng.params))} parameters, "
        f"{weights} B of weights; {toks} tokens, {toks / wall:.1f} tok/s "
        f"wall (init included: {wall:.2f}s); ticks={s['ticks']} "
        f"chunks={s['chunk_prefills']} prefix_hits={s['prefix_hits']} "
        f"hit_tokens={s['prefix_hit_tokens']} pages_high_water="
        f"{s['pages_high_water']}/{pool.num_pages} "
        f"max_memory_allocated={peak} B; launches {counts}")
    # served from the cache, the pair parts from the launcher's fresh
    # stream by rounding: prefix_cache_trace holds that comparison
    log("main-vlm: " + identical_pair(
        eng, "main-vlm", args, launch_serve.encoder_shape(cfg, args),
        against_run=False))
    log("main-vlm: " + prefix_cache_trace(eng, args))
    shapes.stop()
    errs = shapes.parity("main-vlm", eng.device)
    steps_t = mm_step(eng, "main-vlm", *VLM_STEP, embeds=True)
    out = {"launches": {k: counts[k][0] for k in ("paged_attention_mq",
                                                   "rmsnorm")},
           "steps": steps_t, "wall_tok_s": toks / wall, "peak": peak,
           "errs": errs}
    del eng
    return out


def phase_main_whisper() -> dict:
    """main-whisper: whisper-tiny at full width through the launcher's
    ``--audio``: 8 x 24 encode chunks, B3 4 launches an encode chunk (all
    on the tensor cores), B1 4 a decode step or decoder chunk, both pools
    whole; two identical requests; ngram speculation against the plain
    streams; the decode step, a decoder chunk and an encode chunk timed."""
    shapes = KernelShapes()             # every serving call's, to ngram's
    eng, counts, wall, peak = serve_mm(WHISPER_ARGS, "main-whisper")
    args = launch_serve.parse_args(WHISPER_ARGS)
    cfg, s = eng.model.cfg, eng.stats
    Ld = cfg.decoder_layers
    want = {"flash_attention": cfg.n_layers * s["encode_chunks"],
            "flash_attention_tc": cfg.n_layers * s["encode_chunks"],
            "paged_attention_mq": Ld * (s["ticks"] + s["chunk_prefills"])}
    got = {k: counts[k][0] for k in want}
    if s["encode_chunks"] != args.requests * WHISPER_CHUNKS or got != want:
        raise AssertionError(f"main-whisper: encode chunks "
                             f"{s['encode_chunks']} (want "
                             f"{args.requests * WHISPER_CHUNKS}), launches "
                             f"{got}, want {want}")
    others = [k for k, (n, _) in counts.items() if n and k not in
              ("flash_attention", "flash_attention_tc", "paged_attention_mq",
               "paged_attention_mq_split")]
    if others or eng.prefix_cache:
        raise AssertionError(f"main-whisper: {others} launched, prefix "
                             f"cache {eng.prefix_cache}")
    cp, pool = eng.cross_pool, eng.pool
    if (cp.pages_in_use, cp.pages_free) != (0, cp.num_pages) \
            or pool.pages_free + pool.pages_cached + pool.pages_in_use \
            != pool.num_pages:
        raise AssertionError("main-whisper: a pool is not whole")
    toks = sum(len(r.output) for r in eng.finished)
    log(f"main-whisper: whisper-tiny {cfg.n_layers} + {Ld} layers "
        f"{cfg.dtype}, {toks} tokens, {toks / wall:.1f} tok/s wall (init "
        f"included: {wall:.2f}s); ticks={s['ticks']} chunks="
        f"{s['chunk_prefills']} encode_chunks={s['encode_chunks']} "
        f"cross pool {cp.num_pages} pages, max_memory_allocated={peak} B; "
        f"launches {counts}")
    shape = launch_serve.encoder_shape(cfg, args)
    log("main-whisper: " + identical_pair(eng, "main-whisper", args, shape))
    # ngram speculation: prompts whose tail repeats, so the drafter finds
    # n-grams from the first tick on; held against the same requests
    # served plain with their margins recorded
    reqs = [(np.concatenate([p[:16], p[16:24], p[16:24]]), payload)
            for p, payload in launch_serve.make_requests(args, cfg.vocab,
                                                         shape)[:4]]
    kw = engine_kw(args)
    with ServeEngine(eng.model, eng.params, **kw) as plain:
        want_s, margins = serve_margins(plain, reqs, args.max_new)
    with ServeEngine(eng.model, eng.params, spec_decode="ngram",
                     **kw) as spec:
        for p, payload in reqs:
            spec.submit(p, max_new_tokens=args.max_new,
                        encoder_input=payload)
        got_s = {i: r.output for i, r in enumerate(
            sorted(spec.run_until_drained(), key=lambda r: r.rid))}
        ss = spec.stats
    if ss["draft_proposed"] <= 0:
        raise AssertionError("main-whisper ngram: no draft proposed")
    lines = stream_gate("main-whisper ngram", got_s, want_s, margins)
    log(f"main-whisper ngram: proposed={ss['draft_proposed']} accepted="
        f"{ss['draft_accepted']} verify widths {ss['verify_widths']}; "
        + "; ".join(lines))
    shapes.stop()
    errs = shapes.parity("main-whisper", eng.device)
    enc = launch_serve.make_requests(args, cfg.vocab, shape)[0][1]
    n = min(64, len(enc))                   # one full encode chunk
    frames = torch.tensor(enc[None, :n], device=eng.device)
    cpages = torch.arange(n // PS, dtype=torch.int32, device=eng.device)

    def encode():
        k, v = eng.model.cross_kv_chunk(eng.params, eng.model.encode_chunk(
            eng.params, frames, 0, n))
        eng.model.scatter_cross(eng.cross_pool.storage, cpages, k, v,
                                page_size=PS)

    def cross(B):
        nc = eng.sched.cross_pages_per_slot
        return {"storage": eng.cross_pool.storage,
                "tables": torch.arange(B * nc, dtype=torch.int32,
                                       device=eng.device).reshape(B, nc)
                % eng.cross_pool.num_pages,
                "frames_len": torch.full((B,), cfg.n_audio_frames,
                                         dtype=torch.int32,
                                         device=eng.device)}

    steps_t = mm_step(eng, "main-whisper", *WHISPER_STEP, cross=cross,
                      encode=encode)
    out = {"launches": {k: counts[k][0] for k in ("paged_attention_mq",
                                                   "flash_attention",
                                                   "flash_attention_tc")},
           "steps": steps_t, "wall_tok_s": toks / wall, "peak": peak,
           "errs": errs}
    del eng
    return out


def mm_paged_case(rng, dev, B, W, Hq, Hkv, D, P, n_pages, lengths):
    """q (float32), float32 pools with a trash page of large values, tables
    of ``P`` pages whose used part names distinct pages (the rest the trash
    page), the lengths; a length 0 is a dead slot (all trash)."""
    trash = n_pages
    q = torch.randn(B, W, Hq, D, device=dev)
    kp = torch.randn(n_pages + 1, PS, Hkv, D, device=dev)
    vp = torch.randn(n_pages + 1, PS, Hkv, D, device=dev)
    kp[trash], vp[trash] = 1e4, -1e4
    tables = np.full((B, P), trash, np.int32)
    for b, n in enumerate(lengths):
        used = -(-(n + W - 1) // PS) if n else 0
        tables[b, :used] = rng.permutation(n_pages)[:used]
    return (q, kp, vp, torch.tensor(tables, device=dev),
            torch.tensor(np.asarray(lengths, np.int32), device=dev))


def phase_parity_mm(rng, dev) -> dict:
    """B3 and B1 at the multimodal shapes (MM_FLASH, MM_PAGED) against their
    plain versions: B3 bf16, each call one launch on the tensor cores; B1
    with q and pages in bf16 and float32, and int8 pages, a dead slot's
    row 0 zero.  Max abs error by kernel name."""
    from repro_torch.kernels.paged_attention import split_count
    errs = {"flash_attention": 0.0, "paged_attention_mq": 0.0,
            "paged_attention_mq_int8": 0.0}
    for label, (B, Sq, Sk, Hq, Hkv, D, causal) in MM_FLASH.items():
        q = torch.randn(B, Sq, Hq, D, device=dev).to(torch.bfloat16)
        k = torch.randn(B, Sk, Hkv, D, device=dev).to(torch.bfloat16)
        v = torch.randn(B, Sk, Hkv, D, device=dev).to(torch.bfloat16)
        ops.reset_counts()
        got = ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if ops.COUNTS["flash_attention_tc"].kernel != 1:
            raise AssertionError(f"flash_attention {label}: not one launch "
                                 "on the tensor cores")
        errs["flash_attention"] = max(errs["flash_attention"], check(
            "flash_attention", f"{label} {(B, Sq, Sk, Hq, Hkv, D)} causal="
            f"{causal} bf16", got, ref.flash_attention(q, k, v,
                                                       causal=causal),
            torch.bfloat16))
    for label, (B, W, Hq, Hkv, D, P, n_pages, lengths, _) in \
            MM_PAGED.items():
        q, kp, vp, tb, ln = mm_paged_case(rng, dev, B, W, Hq, Hkv, D, P,
                                          n_pages, lengths)
        pages = quantize_pages(kp, vp)
        for dtype in (torch.bfloat16, torch.float32):
            for name, args in (
                    ("paged_attention_mq", (kp.to(dtype), vp.to(dtype), tb,
                                            ln)),
                    ("paged_attention_mq_int8", (pages[0], pages[1], tb, ln,
                                                 *pages[2:]))):
                got = ops.paged_attention_mq(q.to(dtype), *args)
                torch.cuda.synchronize()
                if 0 in lengths and got[list(lengths).index(0), 0].any():
                    raise AssertionError(f"{name} {label}: dead slot not "
                                         "zero")
                errs[name] = max(errs[name], check(
                    name, f"{label} B={B} W={W} Hq={Hq} Hkv={Hkv} D={D} "
                    f"P={P} ({split_count(P, PS)} key ranges) {dtype}", got,
                    ref.paged_attention_mq(q.to(dtype), *args), dtype))
    log(f"parity ok (multimodal shapes): {len(MM_FLASH)} flash_attention "
        f"(bf16, tensor cores: {list(MM_FLASH)}) + {4 * len(MM_PAGED)} "
        f"paged-attention cases ({list(MM_PAGED)}; bf16 and float32, float "
        f"and int8 pages); max abs err {errs}")
    return errs


def phase_timing_mm(dev) -> dict:
    """B3 and B1 timed at the multimodal shapes: device times (a replayed
    CUDA graph) of kernel, plain version and yardstick (SDPA; gather +
    SDPA for B1) beside the bound; B1 over each shape's layers' pools in
    turn.  Returns ``{kernel: {label: times}}``."""
    import torch.nn.functional as F
    rng = np.random.default_rng(11)
    dtype = torch.bfloat16
    out = {"flash_attention": {}, "paged_attention_mq": {}}
    for label, (B, Sq, Sk, Hq, Hkv, D, causal) in MM_FLASH.items():
        q = torch.randn(B, Sq, Hq, D, device=dev).to(dtype)
        k = torch.randn(B, Sk, Hkv, D, device=dev).to(dtype)
        v = torch.randn(B, Sk, Hkv, D, device=dev).to(dtype)
        pairs = Sq * (Sq + 1) // 2 if causal else Sq * Sk
        b, by = bound((2 * q.numel() + k.numel() + v.numel())
                      * q.element_size(), 4 * D * Hq * B * pairs, dtype)
        reps = 1 if Sq > 1000 else 4
        t = {what: device_ms([fn] * reps) for what, fn in (
            ("kernel", lambda: ops.flash_attention(q, k, v, causal=causal)),
            ("plain", lambda: ref.flash_attention(q, k, v, causal=causal)),
            ("library", lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=True)))}
        host = time_ms(lambda: ops.flash_attention(q, k, v, causal=causal))
        out["flash_attention"][label] = {
            "shape": [B, Sq, Sk, Hq, Hkv, D, causal], "ms": t["kernel"],
            "plain_ms": t["plain"], "library_ms": t["library"],
            "bound_ms": b, "bound_by": by, "host_ms": host}
        log(f"timing flash_attention {label} [B={B} Sq={Sq} Sk={Sk} Hq={Hq} "
            f"Hkv={Hkv} D={D} causal={causal} bf16]: device kernel "
            f"{t['kernel']:.5f} ms, plain {t['plain']:.5f} ms, SDPA "
            f"{t['library']:.5f} ms, bound {b:.6f} ms ({by}); host-issued "
            f"kernel {host:.5f} ms")
    for label, (B, W, Hq, Hkv, D, P, n_pages, lengths, n_layers) in \
            MM_PAGED.items():
        q, _, _, tb, ln = mm_paged_case(rng, dev, B, W, Hq, Hkv, D, P,
                                        n_pages, lengths)
        q = q.to(dtype)
        layers = [tuple(torch.randn(n_pages + 1, PS, Hkv, D,
                                    device=dev).to(dtype) for _ in range(2))
                  for _ in range(n_layers)]
        t, b, by = time_window(q, layers, tb, ln,
                               window_mask(ln, W, P * PS))
        out["paged_attention_mq"][label] = {
            "shape": [B, W, Hq, Hkv, D, P, list(lengths)],
            "ms": t["kernel"], "plain_ms": t["plain"],
            "library_ms": t["library"], "bound_ms": b, "bound_by": by}
        log(f"timing paged_attention_mq {label} [B={B} W={W} Hq={Hq} "
            f"Hkv={Hkv} D={D} P={P} lengths={list(lengths)}, {n_layers} "
            f"layers' pools, bf16]: device kernel {t['kernel']:.5f} ms, "
            f"plain {t['plain']:.5f} ms, gather + SDPA {t['library']:.5f} "
            f"ms, bound {b:.6f} ms ({by})")
        del layers
    return out


# -- one-card training and gemma3's window caches (ROADMAP A13a, A11) ----------

# B2's backward at training's (rows, d): qwen3-1.7b's main-train (B 4 x S
# 2048 = 8192 rows at d 2048; its QK-norms over 16 and 8 heads at d 128),
# gemma3's d 2560 and QK-norm d 256 (4 x 2000 rows, 8 and 4 heads), one row
# and a width off the vector.  Every variant: the norm, the fused add with
# its sum read on, and without (a model's final norm)
TRAIN_NORM_CASES = [(8192, 2048), (131072, 128), (65536, 128), (8000, 2560),
                    (64000, 256), (32000, 256), (1, 2048), (7, 1001)]
# max |d| over max(1, max |autograd|): the kernel's gradients from bf16
# rows in float32, rounded once to bf16 (2**-8 of a value), against
# autograd through the plain version in float32 on the same (widened)
# inputs; dscale sums over up to 131072 rows in another order.  float32:
# summation order only
TRAIN_NORM_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}
# B3's backward: (B, S, Hq, Hkv, D, causal, window, dtype): qwen3-1.7b's
# training shape (two sequences of it), gemma3's windowed layers, a ragged
# S, D 64 non-causal (whisper's encoder heads), D 128 windowed at G 4,
# SMOKE's float32 D 16, qwen3-moe's 64/4 heads (G 16, main-train-moe's);
# bf16 at D 64 and 128 on the tensor cores
TRAIN_FLASH_CASES = [(2, 2048, 16, 8, 128, True, None, torch.bfloat16),
                     (1, 2048, 8, 4, 256, True, 1024, torch.bfloat16),
                     (2, 1000, 16, 8, 128, True, None, torch.bfloat16),
                     (2, 1500, 6, 6, 64, False, None, torch.bfloat16),
                     (1, 2048, 16, 4, 128, True, 512, torch.bfloat16),
                     (2, 300, 4, 2, 16, True, None, torch.float32),
                     (2, 2048, 64, 4, 128, True, None, torch.bfloat16)]
# dq, dk, dv are sums of O(1) terms over the keys or queries: bf16 within
# 2e-2 of the largest magnitude (the kernel reads the bf16 forward output
# O for rowsum(dO * O) and rounds its result to bf16 once, where the
# float32 autograd rounds nothing), float32 within 1e-4 (summation order)
TRAIN_FLASH_REL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# B3 with a query offset, training's sequence parallelism (a rank's block
# of Sq queries at q_offset against the Sk = q_offset + Sq keys before its
# last one), forward and backward: (B, Sq, Sk, q_offset, Hq, Hkv, D,
# causal, window, dtype): qwen3-1.7b's second block of a 2048 sequence
# over 2 ranks on the tensor cores, the same windowed, float32 at D 64 on
# CUDA cores, and Sk - Sq = 133, no multiple of any tile
TRAIN_FLASH_OFFSET_CASES = [
    (1, 1024, 2048, 1024, 16, 8, 128, True, None, torch.bfloat16),
    (1, 1024, 2048, 1024, 16, 8, 128, True, 512, torch.bfloat16),
    (2, 130, 260, 130, 4, 2, 64, True, None, torch.float32),
    (2, 200, 333, 133, 8, 4, 128, True, None, torch.bfloat16)]
# main-train: full-width, full-depth qwen3-1.7b, float32 weights and
# moments, bf16 compute, remat full; the launcher's AdamW for 20 steps
TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_STEPS = "qwen3-1.7b", 4, 2048, 20
TRAIN_LR = 1e-3
# timing-train's sequence-parallel block (B, Sq, Sk, q_offset): main-train's
# 4 rows, the second half (1024 queries at 1024) of its 2048 positions
# over 2 ranks
SP_BLOCK = (TRAIN_B, 1024, 2048, 1024)
# main-train-mesh: main-train's first steps through Trainer on a (1, 1)
# ("data", "model") mesh in a run_ranks world of 1 over NCCL; its losses
# and gradient norms within TRAIN_MESH_REL of main-train's (at world 1
# every gather and reduce-scatter is a copy of one rank's tensor, so the
# arithmetic is main-train's: bit equality is expected), its peak within
# TRAIN_MESH_PEAK of main-train's (a layer's weights gathered at a time)
TRAIN_MESH_STEPS = 5
TRAIN_MESH_REL = 1e-5
TRAIN_MESH_PEAK = 1.10
# pod-dp: the same model on a (1, 1, 1) ("pod", "data", "model") mesh at
# world 1, POD_DP_STEPS steps int8-compressed, then as many plain from the
# same state; the reference test's gates
POD_DP_STEPS = 3
POD_DP_LOSS_GAP = 0.05
POD_DP_WIRE = 0.3
# main-train-moe: full-width qwen3-moe-235b-a22b (d 4096, 64/4 heads of
# 128, 128 experts top-8 of ff 1536, vocab 151936, QK-norm) cut to
# TRAIN_MOE_LAYERS layers, bf16 params and AdamW moments as its config
# declares, bf16 compute, remat full, through Trainer at TRAIN_MOE_B x
# TRAIN_S for TRAIN_MOE_STEPS steps.  Its state is 6.22 B params x 8 B (bf16
# param, gradient, m and v) = 49.8 GB; a third layer adds 19.9 GB, so two
# layers are what one 80 GB card holds.  arctic at full width needs 13.4 B
# expert params a layer (107 GB of state), so it trains only at SMOKE (on
# the CPU, in tests/test_torch_moe_train.py)
TRAIN_MOE_LAYERS, TRAIN_MOE_B, TRAIN_MOE_STEPS = 2, 4, 10
# main-train-dots: main-train's config under remat="dots" for
# TRAIN_DOTS_STEPS steps from the same seed: the forward is main-train's,
# and the backward reads the 2-D products' outputs it saved where "full"
# computes them again, on the same inputs, so bit equality is expected;
# the gate is TRAIN_DOTS_REL
TRAIN_DOTS_STEPS = 3
TRAIN_DOTS_REL = 1e-6
CKPT_LAYERS = 2                 # the checkpoint round trip's cut
# small-train: 5 float32 SMOKE steps, card against CPU; the losses within
# 1e-4 and the gradient norms within 1e-3 relative: float32 on both, sums
# in other orders; each Adam step moves every weight by about lr whatever
# its gradient's size, so a near-zero gradient whose sign rounding decides
# moves the next steps' losses by more than its own size
SMALL_TRAIN_REL = {"loss": 1e-4, "grad_norm": 1e-3}
# main-gemma3: full-width, full-depth gemma3-4b (bf16, seed 0) as aligned
# batches: 4 prompts of 2000 tokens (past the 1024 window: the ring's
# compression and its wrap) and 4 of 300 (the ring left-padded), greedy to
# 32 tokens each
GEMMA_ARCH = "gemma3-4b"
GEMMA_BATCHES = ((4, 2000), (4, 300))
GEMMA_NEW = 32
# The teacher-forcing gate: the last decode step's logits against the last
# position of a prefill of the same tokens, over the vocab's 262144 logits
# (~1 rms at random init).  The two reach them through other kernels
# (flash attention's tensor-core route, P as a bf16 pair, against the
# decode's plain attention, GEMMs of other row counts), so bf16 rounds at
# other places (2**-8 of a value) in each of 34 layers: at full depth in
# bf16 within GEMMA_BF16_TOL, about three times the largest gap measured on
# an H100 when the prefill ran on CUDA cores (0.0309 and 0.0288, no flip,
# PERF.md §6: QK-norm keeps this random model far less chaotic than
# qwen2's), the argmax equal unless the prefill's
# top-2 margin is below NEAR_TIE.  The kernels' own shapes are held to
# their plain versions apart from this gate (KernelShapes).
# The same at the first GEMMA_GATE_DEPTH layers (the five windowed layers
# before the first global one, and it) in float32 within GEMMA_F32_TOL:
# summation order only (measured 5.3e-06 and 3.2e-06).
GEMMA_GATE_DEPTH = 6
GEMMA_F32_TOL = 1e-3
GEMMA_BF16_TOL = 0.1
# parity-train, the recurrent families' backward kernels, each against
# autograd through its plain version in float32 on the same (widened)
# inputs and run twice (the same bits): B4 at (B, S, H, K, V, planted
# zeros and as many denormals in w): two sequences of 256, a ragged 200 (no
# multiple of a chunk) and 256 with decays at 0, from a nonzero state, all
# on the chunk-parallel tensor-core route in both dtypes; B5 at (B, S, H,
# P, N), B and C float32 (the CUDA-core route) and bf16 (the tensor-core
# route): 256 steps, and a ragged 200 over two groups of heads (10: 8 and
# 2); the gated norm at main-train-zamba's (rows, d), bf16 z; B3 at
# zamba2's head dim 112 (B, S, Hq, Hkv, D; bf16, causal) forward and
# backward
TRAIN_RWKV_CASES = [(2, 256, 4, 64, 64, 0), (2, 200, 4, 64, 64, 0),
                    (2, 256, 4, 64, 64, 64)]
TRAIN_SSD_CASES = [(2, 256, 8, 64, 64), (1, 200, 10, 64, 64)]
TRAIN_GATED_CASES = [(8192, 7168)]
TRAIN_FLASH_Z = (1, 2048, 32, 32, 112)
# max |d| over max(1, max |autograd|): float32 inputs differ by summation
# order only (the kernel recomputes the states the plain version keeps);
# bf16 r/k/v and B/C have their gradients rounded once to bf16 (2**-8 of a
# value)
SCAN_BWD_REL = {torch.float32: 1e-5, torch.bfloat16: 4e-3}
# main-train-rwkv: full-width, full-depth rwkv6-3b (32 layers, d 2560, 40
# heads of 64, ff 8960, vocab 65536): 3.27 B params, 52.3 GB of float32
# params, gradients and AdamW moments; bf16 compute, remat full; through
# Trainer at TRAIN_REC_B x TRAIN_S for TRAIN_REC_STEPS steps.
# main-train-zamba: full-width zamba2-7b (d 3584, 112 SSM heads of 64, N
# 64, 32/32 heads of 112, ff 14336) cut from 81 to TRAIN_ZAMBA_LAYERS
# Mamba-2 layers, one segment and one application of the shared block:
# 2.54 B params, 40.6 GB of state (the full 81 layers hold 6.75 B, 108
# GB; two segments 4.64 B, 74 GB before any activation)
TRAIN_RWKV_ARCH, TRAIN_ZAMBA_ARCH, TRAIN_ZAMBA_LAYERS = \
    "rwkv6-3b", "zamba2-7b", 27
TRAIN_REC_B, TRAIN_REC_STEPS = 4, 5


def grads_of(fn, tensors, cots):
    """Gradients of ``fn(*tensors)`` (one output or a tuple, None entries
    skipped) against the cotangents ``cots``, on detached copies."""
    leaves = [t.detach().clone().requires_grad_(True) for t in tensors]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    pairs = [(o, c) for o, c in zip(outs, cots) if o is not None]
    return torch.autograd.grad([o for o, _ in pairs], leaves,
                               [c for _, c in pairs])


def grad_gap(got, want) -> tuple[float, float]:
    """(max |d|, max |d| over max(1, max |want|))."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(1.0, want.float().abs().max().item())


def norm_bwd_gap(dev, variant, rows, d, dtype, keep_sum, what,
                 sdtype=torch.float32, eps=1e-6) -> tuple[float, float]:
    """B2's backward for ``variant`` ("rmsnorm", or "add_rmsnorm" with or
    without its sum read on) on seeded random rows against autograd
    through the plain version in float32 on the same (widened) inputs:
    (max |d|, max |d| over max(1, max |autograd|)) over its gradients;
    raises past TRAIN_NORM_TOL."""
    from repro_torch.kernels.rmsnorm import add_rmsnorm_plain, rmsnorm_plain
    x, dl, gy, gs = (torch.randn(rows, d, device=dev).to(dtype)
                     for _ in range(4))
    scale = (1 + 0.1 * torch.randn(d, device=dev)).to(sdtype)
    f32 = [t.float() for t in (x, dl, scale)]
    if variant == "rmsnorm":
        names = ("dx", "dscale")
        got = grads_of(lambda a, c: ops.rmsnorm(a, c, eps=eps), (x, scale),
                       (gy,))
        want = grads_of(lambda a, c: rmsnorm_plain(a, c, eps=eps),
                        (f32[0], f32[2]), (gy.float(),))
    else:
        names = ("dx", "ddelta", "dscale")
        got = grads_of(lambda a, b, c: ops.add_rmsnorm(
            a, b, c, eps=eps, keep_sum=keep_sum), (x, dl, scale), (gs, gy))
        want = grads_of(lambda a, b, c: add_rmsnorm_plain(
            a, b, c, eps=eps, keep_sum=keep_sum), f32,
            (gs.float(), gy.float()))
    torch.cuda.synchronize()
    worst = (0.0, 0.0)
    for g, w, name in zip(got, want, names):
        e, r = grad_gap(g, w)
        if r > TRAIN_NORM_TOL[dtype]:
            raise AssertionError(f"{what}: B2 backward {name} {r} > "
                                 f"{TRAIN_NORM_TOL[dtype]}")
        worst = (max(worst[0], e), max(worst[1], r))
    return worst


def flash_bwd_gap(dev, B, S, Hq, Hkv, D, causal, window, dtype,
                  what, Sk=None, q_offset=0) -> tuple[float, float]:
    """B3's backward (S queries at ``q_offset``, ``Sk`` keys: S unless
    given) on seeded random inputs against autograd through the plain
    version in float32 on the same (widened) inputs: (max |d|, max |d|
    over max(1, max |autograd|)) over dq, dk, dv; raises past
    TRAIN_FLASH_REL."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    Sk = S if Sk is None else Sk
    q, g = (torch.randn(B, S, Hq, D, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn(B, Sk, Hkv, D, device=dev).to(dtype)
            for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = grads_of(lambda a, b, c: ops.flash_attention(a, b, c, **kw),
                   (q, k, v), (g,))
    want = grads_of(lambda a, b, c: flash_attention_plain(a, b, c, **kw),
                    tuple(t.float() for t in (q, k, v)), (g.float(),))
    torch.cuda.synchronize()
    worst = (0.0, 0.0)
    for gg, w, name in zip(got, want, ("dq", "dk", "dv")):
        e, r = grad_gap(gg, w)
        if r > TRAIN_FLASH_REL[dtype]:
            raise AssertionError(f"{what}: B3 backward {name} {r} > "
                                 f"{TRAIN_FLASH_REL[dtype]}")
        worst = (max(worst[0], e), max(worst[1], r))
    return worst


def phase_parity_train(dev) -> dict:
    """B2's and B3's backward kernels against autograd through their plain
    versions in float32 on the same inputs: B2's three variants (the norm,
    the fused add with and without its sum) at TRAIN_NORM_CASES in bf16
    and float32, B3 at TRAIN_FLASH_CASES, each gated on its relative gap;
    then B3 with a query offset (TRAIN_FLASH_OFFSET_CASES), forward under
    TOL and backward, its launches counted apart.  Returns the max abs
    error by kernel (and logs the relative ones) and the offset calls'
    launches."""
    torch.manual_seed(1)
    errs = {"rmsnorm_bwd": 0.0, "flash_attention_bwd": 0.0}
    rels = dict(errs)

    def keep(name, gap):
        errs[name] = max(errs[name], gap[0])
        rels[name] = max(rels[name], gap[1])

    ops.reset_counts()
    for dtype in (torch.bfloat16, torch.float32):
        for rows, d in TRAIN_NORM_CASES:
            for variant, keep_sum in (("rmsnorm", True),
                                      ("add_rmsnorm", True),
                                      ("add_rmsnorm", False)):
                keep("rmsnorm_bwd", norm_bwd_gap(
                    dev, variant, rows, d, dtype, keep_sum,
                    f"parity-train {variant} keep_sum={keep_sum} "
                    f"rows={rows} d={d} {dtype}"))
    for B, S, Hq, Hkv, D, causal, window, dtype in TRAIN_FLASH_CASES:
        keep("flash_attention_bwd", flash_bwd_gap(
            dev, B, S, Hq, Hkv, D, causal, window, dtype,
            f"parity-train flash_attention B={B} S={S} Hq={Hq} Hkv={Hkv} "
            f"D={D} window={window} {dtype}"))
    counts = {k: (c.kernel, c.plain) for k, c in ops.COUNTS.items()
              if c.kernel or c.plain}
    want_b2 = 2 * 3 * len(TRAIN_NORM_CASES)
    want_tc = sum(dt == torch.bfloat16 and D in (64, 128)
                  for _, _, _, _, D, _, _, dt in TRAIN_FLASH_CASES)
    if (counts.get("rmsnorm_bwd", (0, 0))[0] != want_b2
            or counts.get("flash_attention_bwd", (0, 0))[0]
            != len(TRAIN_FLASH_CASES)
            or counts.get("flash_attention_bwd_tc", (0, 0))[0] != want_tc):
        raise AssertionError(f"parity-train: backward launches {counts}; "
                             f"want {want_tc} on the tensor cores")
    # B3 with a query offset, forward then backward, its launches apart
    ops.reset_counts()
    off_err = 0.0
    for (B, Sq, Sk, off, Hq, Hkv, D, causal, window,
         dtype) in TRAIN_FLASH_OFFSET_CASES:
        what = (f"parity-train flash_attention B={B} Sq={Sq} Sk={Sk} "
                f"q_offset={off} Hq={Hq} Hkv={Hkv} D={D} window={window} "
                f"{dtype}")
        q = torch.randn(B, Sq, Hq, D, device=dev).to(dtype)
        k, v = (torch.randn(B, Sk, Hkv, D, device=dev).to(dtype)
                for _ in range(2))
        kw = dict(causal=causal, window=window, q_offset=off)
        off_err = max(off_err, check(
            "flash_attention", what, ops.flash_attention(q, k, v, **kw),
            ref.flash_attention(q, k, v, **kw), dtype))
        del q, k, v
        keep("flash_attention_bwd", flash_bwd_gap(
            dev, B, Sq, Hq, Hkv, D, causal, window, dtype, what, Sk=Sk,
            q_offset=off))
    off_counts = {k: c.kernel for k, c in ops.COUNTS.items() if c.kernel}
    n_off = len(TRAIN_FLASH_OFFSET_CASES)
    tc_fwd = sum(dt == torch.bfloat16 and c[6] in (64, 128, 256)
                 for *c, dt in TRAIN_FLASH_OFFSET_CASES)
    tc_bwd = sum(dt == torch.bfloat16 and c[6] in (64, 128)
                 for *c, dt in TRAIN_FLASH_OFFSET_CASES)
    want_off = {"flash_attention": 2 * n_off, "flash_attention_tc": 2 * tc_fwd,
                "flash_attention_bwd": n_off, "flash_attention_bwd_tc": tc_bwd}
    if off_counts != want_off or any(c.plain for c in ops.COUNTS.values()):
        raise AssertionError(f"parity-train: the offset calls launched "
                             f"{off_counts}; want {want_off}, no plain call")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"parity-train: B3 with a query offset at "
        f"{[c[:9] for c in TRAIN_FLASH_OFFSET_CASES]}: forward max abs "
        f"{off_err:.3e} (limits {TOL['flash_attention']}), the backward "
        f"within the limits above; launches {off_counts} (forward twice a "
        f"case: alone and under autograd; bf16 D 64/128 on the tensor "
        f"cores both ways)")
    log(f"parity-train: B2's backward (rmsnorm, add_rmsnorm with and "
        f"without its sum) at (rows, d) {TRAIN_NORM_CASES}, bf16 (limit "
        f"{TRAIN_NORM_TOL[torch.bfloat16]}: one bf16 rounding of the "
        f"gradient) and float32 (limit {TRAIN_NORM_TOL[torch.float32]}: "
        f"summation order), and B3's backward at {[c[:7] for c in TRAIN_FLASH_CASES]} "
        f"(bf16 limit {TRAIN_FLASH_REL[torch.bfloat16]}: the bf16 forward "
        f"output and one rounding of the gradient; float32 "
        f"{TRAIN_FLASH_REL[torch.float32]}; bf16 D 64/128 on the tensor "
        f"cores, P and dS rounded to bf16 once), each against autograd "
        f"through the plain version in float32: max |d| over max(1, max "
        f"|autograd|) "
        f"{rels}, max |d| {errs}; launches {counts}")
    errs["flash_attention"] = off_err
    return errs, off_counts


def phase_small_train(dev) -> None:
    """5 trainer steps of float32 SMOKE qwen3-1.7b on the card (B2's and
    B3's backward kernels) against the same on the CPU, from the same
    seeded weights and batches."""
    from repro_torch.data import SyntheticTask, make_data_iter
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig
    model = build_model(smoke_config(TRAIN_ARCH))
    params = model.init(0, device="cpu", dtype=torch.float32)
    hist = {}
    for where in ("cpu", "cuda"):
        ops.reset_counts()
        tr = Trainer(model, AdamWConfig(peak_lr=1e-3, warmup_steps=1,
                                        decay_steps=5),
                     TrainerConfig(steps=5, log_every=100),
                     make_data_iter(SyntheticTask(model.cfg, 4, 64),
                                    device=where),
                     device=where, params=params, log=lambda s: None)
        hist[where] = tr.fit()["history"]
    counts = {k: c.kernel for k, c in ops.COUNTS.items() if c.kernel}
    if (any(c.plain for c in ops.COUNTS.values())
            or counts.get("flash_attention_bwd") != 5 * model.cfg.n_layers
            or not counts.get("rmsnorm_bwd")):
        raise AssertionError(f"small-train: card launches {counts}")
    gaps = {key: max(abs(a[key] - b[key]) / abs(a[key])
                     for a, b in zip(hist["cpu"], hist["cuda"]))
            for key in SMALL_TRAIN_REL}
    for key, lim in SMALL_TRAIN_REL.items():
        if gaps[key] > lim:
            raise AssertionError(f"small-train: {key} card vs CPU "
                                 f"{gaps[key]} > {lim}: "
                                 f"{[(a[key], b[key]) for a, b in zip(hist['cpu'], hist['cuda'])]}")
    log(f"small-train: 5 steps of SMOKE {TRAIN_ARCH} (float32) card == CPU: "
        f"losses {[round(h['loss'], 6) for h in hist['cuda']]}, largest "
        f"relative gaps {gaps} (limits {SMALL_TRAIN_REL}); card launches "
        f"{counts}")
    ops.reset_counts()


def phase_main_train(dev) -> dict:
    """Full-width, full-depth qwen3-1.7b through ``Trainer``: 20 steps of 4
    x 2048 tokens, float32 weights and AdamW moments, bf16 compute, remat
    full, counts from 0.  Then one step profiled, B3 and B2 held against
    their plain versions at every shape the steps called them at (forward
    and backward: :class:`KernelShapes`), and a checkpoint round trip at
    full width cut to CKPT_LAYERS layers."""
    import shutil
    from repro_torch.data import SyntheticTask, make_data_iter
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (Trainer, TrainerConfig,
                                   create_train_state, restore_checkpoint,
                                   save_checkpoint)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg)
    L = cfg.n_layers
    n_params = sum(int(np.prod(p.shape)) for p in tree_leaves(
        model.param_defs()))
    opt = AdamWConfig(peak_lr=TRAIN_LR, warmup_steps=max(TRAIN_STEPS // 10, 1),
                      decay_steps=TRAIN_STEPS)
    task = SyntheticTask(cfg, batch=TRAIN_B, seq_len=TRAIN_S)
    tr = Trainer(model, opt, TrainerConfig(steps=TRAIN_STEPS, log_every=5),
                 make_data_iter(task, device=dev), device=dev, seed=0,
                 log=log)
    ops.reset_counts()
    shapes = KernelShapes()
    t0 = time.perf_counter()
    try:
        h = tr.fit()["history"]
    finally:
        shapes.stop()
    wall = time.perf_counter() - t0
    counts = {k: (c.kernel, c.plain) for k, c in ops.COUNTS.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in h]
    log(f"[train] {TRAIN_ARCH}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"over {len(h)} steps; stragglers={tr.stragglers}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"main-train: losses {losses}")
    alone, add, _ = qwen_norms(cfg)             # one forward's
    n = TRAIN_STEPS
    # the forward's norms run twice (remat recomputes every block) but the
    # final norm, which lies outside the blocks, once; the backward once
    want = train_launches_wanted(cfg, n)
    check_train_launches("main-train", counts, want)
    times = [m["step_time"] for m in h[2:]]
    host = float(np.median(times)) * 1e3
    state = tr.final_state
    batch = next(make_data_iter(task, device=dev, start_step=TRAIN_STEPS))
    split = train_step_split(model, opt, state, batch)
    devt = split["device_ms"]
    log(f"main-train: {TRAIN_ARCH} {L} layers d {cfg.d_model} "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim} vocab "
        f"{cfg.vocab}, float32 weights and moments, {cfg.dtype} compute, "
        f"remat {cfg.remat}, batch {TRAIN_B} x {TRAIN_S}, {TRAIN_STEPS} steps "
        f"in {wall:.1f} s: losses {[round(x, 4) for x in losses]}; grad norms "
        f"{[round(m['grad_norm'], 3) for m in h]}; a step host-issued "
        f"{host:.1f} ms (median of steps 3-{n}), device {devt:.1f} ms (one "
        f"step profiled: card idle {max(0.0, 1 - devt / host):.1%}), "
        f"{TRAIN_B * TRAIN_S / host * 1e3:.0f} tokens/s; "
        f"max_memory_allocated={peak} B against the state's {n_params} "
        f"params x 16 B = {n_params * 16} B (float32 params, gradients, m, "
        f"v); launches {counts} (B3 {2 * L} a step forward, the blocks' "
        f"recompute included, all on the tensor cores, {L} backward, all on "
        f"the tensor cores; B2 "
        f"{alone + add} backward a step, {add} of them the fused add's); "
        f"a step after them: {split_line(split)}")
    del state, batch, tr
    gc.collect()
    torch.cuda.empty_cache()
    errs = shapes.parity("main-train", dev)
    gc.collect()
    torch.cuda.empty_cache()
    # the checkpoint round trip, full width cut in depth
    cut = build_model(cfg.replace(n_layers=CKPT_LAYERS))
    st = create_train_state(cut, 1, opt, device=dev)
    ckdir = str(pathlib.Path(__file__).resolve().parent / "build"
                / "ckpt_main_train")
    shutil.rmtree(ckdir, ignore_errors=True)
    t0 = time.perf_counter()
    save_checkpoint(ckdir, 7, st)
    t_save = time.perf_counter() - t0
    like = create_train_state(cut, 2, opt, device=dev)
    t0 = time.perf_counter()
    got, step = restore_checkpoint(ckdir, like)
    t_restore = time.perf_counter() - t0
    equal = step == 7 and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(st), tree_leaves(got)))
    size = sum(f.stat().st_size for f in pathlib.Path(ckdir).rglob("*.npy"))
    shutil.rmtree(ckdir, ignore_errors=True)
    if not equal:
        raise AssertionError("main-train: the restored checkpoint differs")
    log(f"main-train checkpoint: {TRAIN_ARCH} at full width cut to "
        f"{CKPT_LAYERS} of {L} layers, {len(tree_leaves(st))} leaves, {size} "
        f"B of .npy, saved in {t_save:.1f} s and restored in "
        f"{t_restore:.1f} s, bit for bit equal")
    del st, like, got
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": {k: counts[k][0] for k in want},
            "host_ms": host, "device_ms": devt, "peak": peak,
            "losses": losses, "grad_norms": [m["grad_norm"] for m in h],
            "errs": errs}


def _train_mesh_rank(comm) -> dict:
    """A world-1 rank on the card (NCCL): main-train's first
    TRAIN_MESH_STEPS steps through ``Trainer`` on ``make_debug_mesh(1, 1)``
    (the state sharded at birth, a layer's weights gathered inside its
    block, the K/V gathered over "model", the gradients reduce-scattered),
    one more step profiled; then pod-dp on a (1, 1, 1) ("pod", "data",
    "model") mesh, POD_DP_STEPS steps compressed and as many plain, each
    from the seeded state."""
    from repro_torch.data import SyntheticTask, make_data_iter
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.mesh import rules_for_mesh
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig, make_train_step
    from repro_torch.train.pod_dp import make_pod_dp_step
    dev = torch.device("cuda")
    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg)
    mesh = make_debug_mesh(1, 1)
    rules = rules_for_mesh(mesh)
    opt = AdamWConfig(peak_lr=TRAIN_LR, warmup_steps=max(TRAIN_STEPS // 10, 1),
                      decay_steps=TRAIN_STEPS)
    task = SyntheticTask(cfg, batch=TRAIN_B, seq_len=TRAIN_S)
    specs = model.train_batch_specs(type("S", (), {
        "global_batch": TRAIN_B, "seq_len": TRAIN_S})())
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(model, opt, TrainerConfig(steps=TRAIN_MESH_STEPS,
                                           log_every=TRAIN_MESH_STEPS),
                 make_data_iter(task, mesh, rules, specs, device=dev),
                 mesh=mesh, rules=rules, device=dev, seed=0, log=log)
    ops.reset_counts()
    t0 = time.perf_counter()
    h = tr.fit()["history"]
    wall = time.perf_counter() - t0
    counts = {k: (c.kernel, c.plain) for k, c in ops.COUNTS.items()
              if c.kernel or c.plain}
    peak = torch.cuda.max_memory_allocated()
    state = tr.final_state
    batch = next(make_data_iter(task, mesh, rules, specs, device=dev,
                                start_step=TRAIN_MESH_STEPS))
    step = make_train_step(model, opt, mesh, rules)
    devt, nccl, copies = profiled_parts(lambda: step(state, batch), iters=1)
    del state, batch, tr, step
    gc.collect()
    torch.cuda.empty_cache()
    out = {"losses": [m["loss"] for m in h],
           "grad_norms": [m["grad_norm"] for m in h],
           "step_times": [m["step_time"] for m in h], "counts": counts,
           "peak": peak, "device_ms": devt, "nccl_ms": nccl,
           "copy_ms": copies, "wall": wall,
           "groups": [mesh.comm(a).size() for a in mesh.axis_names]}
    pmesh = comm_lib.make_mesh((1, 1, 1), ("pod", "data", "model"))
    prules = rules_for_mesh(pmesh)
    for compress in (True, False):
        ps = make_pod_dp_step(model, opt, pmesh, prules, compress=compress)
        st = ps.init_state(0, device=dev)
        outs, ts = [], []
        for i in range(POD_DP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, o = ps(st, task.batch_at(i))
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
            outs.append(o)
        out["pod", compress] = {"outs": outs, "times": ts}
        del st, ps
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_main_train_mesh(train) -> dict:
    """main-train-mesh and pod-dp (:func:`_train_mesh_rank`) in
    ``run_ranks(world=1)`` on the card.  Gates: the losses and gradient
    norms within TRAIN_MESH_REL of main-train's first steps, B2's and B3's
    launches a step (forward and backward) main-train's, no plain call,
    the peak within TRAIN_MESH_PEAK of main-train's; pod-dp's last losses
    within POD_DP_LOSS_GAP and its wire under POD_DP_WIRE of float32."""
    t0 = time.perf_counter()
    r = comm_lib.run_ranks(_train_mesh_rank, (), world=1,
                           store_dir=STORE_DIR, device="cuda")[0]
    if torch.distributed.is_initialized():
        raise AssertionError("main-train-mesh: a process group was left")
    n = TRAIN_MESH_STEPS
    want = {"losses": train["losses"][:n],
            "grad_norms": train["grad_norms"][:n]}
    gaps = {k: max(abs(a - b) / abs(b) for a, b in zip(r[k], want[k]))
            for k in want}
    bitwise = all(r[k] == want[k] for k in want)
    for k, g in gaps.items():
        if not g <= TRAIN_MESH_REL:
            raise AssertionError(f"main-train-mesh: {k} {r[k]} against "
                                 f"main-train's {want[k]} (gap {g})")
    per_step = {k: train["launches"][k] / TRAIN_STEPS
                for k in train["launches"]}
    got = {k: r["counts"].get(k, (0, 0))[0] / n for k in per_step}
    extra = {k: c for k, c in r["counts"].items()
             if c[1] or k not in per_step}
    if got != per_step or extra:
        raise AssertionError(f"main-train-mesh: launches a step {got}, "
                             f"main-train's {per_step}; other {extra}")
    if r["peak"] > TRAIN_MESH_PEAK * train["peak"]:
        raise AssertionError(f"main-train-mesh: peak {r['peak']} B above "
                             f"{TRAIN_MESH_PEAK} x main-train's "
                             f"{train['peak']} B")
    host = float(np.median(r["step_times"][2:])) * 1e3
    log(f"main-train-mesh: {TRAIN_ARCH} through Trainer(mesh="
        f"make_debug_mesh(1, 1)) in run_ranks(world=1, NCCL), groups of "
        f"{r['groups']}, {n} steps of {TRAIN_B} x {TRAIN_S} in "
        f"{r['wall']:.1f} s: losses {r['losses']} (main-train's "
        f"{want['losses']}), grad norms {r['grad_norms']} (main-train's "
        f"{want['grad_norms']}): {'bit for bit equal' if bitwise else 'largest relative gaps ' + str(gaps)} "
        f"(limit {TRAIN_MESH_REL}); launches a step {got} = main-train's; "
        f"a step host-issued {host:.1f} ms (median of steps 3-{n}; "
        f"main-train {train['host_ms']:.1f} ms), device {r['device_ms']:.1f} "
        f"ms (one step profiled; NCCL's kernels {r['nccl_ms']:.2f} ms and "
        f"device-to-device copies {r['copy_ms']:.2f} ms of it: NCCL over one "
        f"rank copies; main-train {train['device_ms']:.1f} ms); "
        f"max_memory_allocated "
        f"{r['peak']} B = {r['peak'] / train['peak']:.4f} x main-train's "
        f"{train['peak']} B (limit {TRAIN_MESH_PEAK})")
    comp, plain = r["pod", True]["outs"], r["pod", False]["outs"]
    gap = abs(comp[-1]["loss"] - plain[-1]["loss"])
    wire, fp32 = comp[-1]["wire_bytes"], comp[-1]["fp32_bytes"]
    if not gap < POD_DP_LOSS_GAP or not wire < POD_DP_WIRE * fp32:
        raise AssertionError(f"pod-dp: last losses {comp[-1]['loss']} / "
                             f"{plain[-1]['loss']}, wire {wire} of {fp32} B")
    log(f"pod-dp: {TRAIN_ARCH} on a (1, 1, 1) (pod, data, model) mesh in "
        f"run_ranks(world=1, NCCL), {POD_DP_STEPS} steps int8 + error "
        f"feedback then {POD_DP_STEPS} plain from the seeded state: losses "
        f"{[o['loss'] for o in comp]} / {[o['loss'] for o in plain]}, |last "
        f"gap| {gap:.6f} (limit {POD_DP_LOSS_GAP}); wire {wire} B against "
        f"{fp32} B of float32 ({wire / fp32:.4f}, limit {POD_DP_WIRE}); step "
        f"times {[round(t * 1e3, 1) for t in r['pod', True]['times']]} / "
        f"{[round(t * 1e3, 1) for t in r['pod', False]['times']]} ms; both "
        f"phases {time.perf_counter() - t0:.1f} s")
    return {"launches": {k: r["counts"].get(k, (0, 0))[0]
                         for k in per_step},
            "steps": n, "peak": r["peak"], "host_ms": host,
            "device_ms": r["device_ms"], "nccl_ms": r["nccl_ms"],
            "copy_ms": r["copy_ms"]}


def train_launches_wanted(cfg, steps: int) -> dict:
    """B2's and B3's launches in ``steps`` steps of a qwen3-style decoder
    under remat (each block's forward twice, the final norm once, the
    backward once), every B3 call on the tensor cores both ways."""
    L = cfg.n_layers
    alone, add, _ = qwen_norms(cfg)
    return {"flash_attention": 2 * L * steps,
            "flash_attention_tc": 2 * L * steps,
            "flash_attention_bwd": L * steps,
            "flash_attention_bwd_tc": L * steps,
            "rmsnorm": (2 * (alone + add) - 1) * steps,
            "rmsnorm_add": (2 * add - 1) * steps,
            "rmsnorm_bwd": (alone + add) * steps,
            "rmsnorm_add_bwd": add * steps}


def check_train_launches(label: str, counts: dict, want: dict) -> None:
    """Every count ``want`` names as wanted, no other kernel, no plain
    call."""
    bad = {k: c for k, c in counts.items() if c[1] or (
        k in want and c[0] != want[k]) or (k not in want and c[0])}
    if bad:
        raise AssertionError(f"{label}: launches {counts}; want {want}, no "
                             "other kernel and no plain version")


def phase_main_train_moe(dev) -> dict:
    """Full-width qwen3-moe-235b-a22b cut to TRAIN_MOE_LAYERS layers through
    ``Trainer``: TRAIN_MOE_STEPS steps of TRAIN_MOE_B x TRAIN_S, bf16 params
    and moments (its config's ``param_dtype`` / ``moment_dtype``), bf16
    compute, remat full, counts from 0.  Gates: every loss finite and the
    last below the first; B3 forward and backward (G 16) all on the tensor
    cores and B2's launches a step as :func:`train_launches_wanted` says;
    no plain version; then B2 and B3 held against their plain versions at
    every shape the steps called them at, forward and backward.  Prints the
    losses and the aux a step, a step's host-issued and profiled device ms,
    tokens/s and the peak beside the state's bytes."""
    from repro_torch.data import SyntheticTask, make_data_iter
    from repro_torch.models.module import torch_dtype
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(MOE_ARCH).replace(n_layers=TRAIN_MOE_LAYERS)
    model = build_model(cfg)
    n = TRAIN_MOE_STEPS
    n_params = sum(int(np.prod(p.shape)) for p in tree_leaves(
        model.param_defs()))
    pdt, mdt = torch_dtype(cfg.param_dtype), torch_dtype(cfg.moment_dtype)
    state_bytes = n_params * (2 * pdt.itemsize + 2 * mdt.itemsize)
    opt = AdamWConfig(peak_lr=TRAIN_LR, warmup_steps=max(n // 10, 1),
                      decay_steps=n, moment_dtype=mdt)
    task = SyntheticTask(cfg, batch=TRAIN_MOE_B, seq_len=TRAIN_S)
    tr = Trainer(model, opt, TrainerConfig(steps=n, log_every=5),
                 make_data_iter(task, device=dev), device=dev, seed=0,
                 param_dtype=pdt, log=log)
    ops.reset_counts()
    shapes = KernelShapes()
    t0 = time.perf_counter()
    try:
        h = tr.fit()["history"]
    finally:
        shapes.stop()
    wall = time.perf_counter() - t0
    counts = {k: (c.kernel, c.plain) for k, c in ops.COUNTS.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in h]
    auxes = [m["aux"] for m in h]
    log(f"[train] {MOE_ARCH} ({TRAIN_MOE_LAYERS} layers): loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} over {len(h)} steps; "
        f"stragglers={tr.stragglers}")
    if not all(np.isfinite(losses + auxes)) or not losses[-1] < losses[0]:
        raise AssertionError(f"main-train-moe: losses {losses}, aux {auxes}")
    want = train_launches_wanted(cfg, n)
    check_train_launches("main-train-moe", counts, want)
    host = float(np.median([m["step_time"] for m in h[2:]])) * 1e3
    state = tr.final_state
    batch = next(make_data_iter(task, device=dev, start_step=n))
    split = train_step_split(model, opt, state, batch)
    devt = split["device_ms"]
    L = cfg.n_layers
    alone, add, _ = qwen_norms(cfg)
    log(f"main-train-moe: {MOE_ARCH} at full width cut to {L} of "
        f"{get_config(MOE_ARCH).n_layers} layers (d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, "
        f"{cfg.n_experts} experts top-{cfg.top_k} of ff {cfg.expert_d_ff}, "
        f"capacity factor {cfg.capacity_factor}, vocab {cfg.vocab}), "
        f"{cfg.param_dtype} params, {cfg.moment_dtype} moments, {cfg.dtype} "
        f"compute, remat {cfg.remat}, batch {TRAIN_MOE_B} x {TRAIN_S}, {n} "
        f"steps in {wall:.1f} s: losses {[round(x, 4) for x in losses]}; "
        f"aux {[round(x, 5) for x in auxes]}; ce "
        f"{[round(m['ce'], 4) for m in h]}; grad norms "
        f"{[round(m['grad_norm'], 3) for m in h]}; a step host-issued "
        f"{host:.1f} ms (median of steps 3-{n}), device {devt:.1f} ms (one "
        f"step profiled: card idle {max(0.0, 1 - devt / host):.1%}), "
        f"{TRAIN_MOE_B * TRAIN_S / host * 1e3:.0f} tokens/s; "
        f"max_memory_allocated={peak} B against the state's {n_params} "
        f"params x {state_bytes // n_params} B = {state_bytes} B ({pdt} "
        f"params and gradients, {mdt} m and v); launches {counts} (B3 "
        f"{2 * L} a step forward, the blocks' recompute included, and {L} "
        f"backward, all on the tensor cores at G "
        f"{cfg.n_heads // cfg.n_kv_heads}; B2 {alone + add} backward a "
        f"step, {add} of them the fused add's); a step after them: "
        f"{split_line(split)}")
    del state, batch, tr
    gc.collect()
    torch.cuda.empty_cache()
    errs = shapes.parity("main-train-moe", dev)
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": {k: counts[k][0] for k in want}, "host_ms": host,
            "device_ms": devt, "peak": peak, "state_bytes": state_bytes,
            "losses": losses, "aux": auxes, "split": split, "errs": errs}


def phase_main_train_dots(dev, train) -> dict:
    """main-train's model, seed, batches and AdamW for TRAIN_DOTS_STEPS
    steps under ``remat="dots"`` (the outputs of the blocks' 2-D products
    saved, everything else recomputed).  Gates: the losses within
    TRAIN_DOTS_REL of main-train's first ones, B2's and B3's launches a
    step main-train's (B3's and B2's autograd Functions are recomputed, as
    under "full"), no plain version.  Prints the peak and a step's
    profiled device time beside main-train's."""
    from repro_torch.data import SyntheticTask, make_data_iter
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig, make_train_step
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(TRAIN_ARCH).replace(remat="dots")
    model = build_model(cfg)
    n = TRAIN_DOTS_STEPS
    opt = AdamWConfig(peak_lr=TRAIN_LR, warmup_steps=max(TRAIN_STEPS // 10, 1),
                      decay_steps=TRAIN_STEPS)
    task = SyntheticTask(cfg, batch=TRAIN_B, seq_len=TRAIN_S)
    tr = Trainer(model, opt, TrainerConfig(steps=n, log_every=n),
                 make_data_iter(task, device=dev), device=dev, seed=0,
                 log=log)
    ops.reset_counts()
    t0 = time.perf_counter()
    h = tr.fit()["history"]
    wall = time.perf_counter() - t0
    counts = {k: (c.kernel, c.plain) for k, c in ops.COUNTS.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in h]
    want_losses = train["losses"][:n]
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
    if not gap <= TRAIN_DOTS_REL:
        raise AssertionError(f"main-train-dots: losses {losses} against "
                             f"main-train's {want_losses} (gap {gap})")
    per_step = {k: v // TRAIN_STEPS for k, v in train["launches"].items()}
    check_train_launches("main-train-dots", counts,
                         {k: v * n for k, v in per_step.items()})
    state = tr.final_state
    batch = next(make_data_iter(task, device=dev, start_step=n))
    step = make_train_step(model, opt)
    devt, _ = profiled_ms(lambda: step(state, batch), iters=1)
    log(f"main-train-dots: {TRAIN_ARCH} as main-train under remat "
        f"{cfg.remat!r}, {n} steps in {wall:.1f} s: losses {losses} "
        f"(main-train's {want_losses}: "
        f"{'bit for bit equal' if losses == want_losses else f'largest relative gap {gap}'}"
        f", limit {TRAIN_DOTS_REL}); launches a step {per_step} = "
        f"main-train's; a step host-issued {[round(m['step_time'] * 1e3, 1) for m in h]} ms, "
        f"device {devt:.1f} ms (one step profiled; main-train under 'full' "
        f"{train['device_ms']:.1f} ms); max_memory_allocated {peak} B "
        f"(main-train {train['peak']} B: {peak / train['peak']:.4f} x)")
    del state, batch, tr, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"device_ms": devt, "peak": peak, "losses": losses}


def bwd_twice(what, fn, tensors, cots):
    """:func:`grads_of` twice on the same inputs: raises unless the two
    runs give the same bits; the first run's gradients."""
    a, b = (grads_of(fn, tensors, cots) for _ in range(2))
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{what}: two runs of the backward differ")
    return a


def gaps_within(what, names, got, want, limit) -> tuple[float, float]:
    """(max |d|, max |d| over max(1, max |want|)) over the gradients;
    raises past ``limit``."""
    worst = (0.0, 0.0)
    for g, w, name in zip(got, want, names):
        e, r = grad_gap(g, w)
        if r > limit:
            raise AssertionError(f"{what}: {name} {r} > {limit}")
        worst = (max(worst[0], e), max(worst[1], r))
    return worst


def phase_parity_train_recurrent(dev) -> dict:
    """parity-train's recurrent half: B4's and B5's backward kernels
    (TRAIN_RWKV_CASES, TRAIN_SSD_CASES; float32 and bf16 r/k/v or B/C),
    the gated norm's (TRAIN_GATED_CASES) and B3 at head dim 112
    (TRAIN_FLASH_Z, forward under TOL), each backward against autograd
    through its plain version in float32 on the same inputs and run twice,
    the same bits.  Returns the max abs errors by kernel."""
    rng = np.random.default_rng(29)
    torch.manual_seed(29)
    errs = {"rwkv6_scan_bwd": 0.0, "ssd_scan_bwd": 0.0,
            "rmsnorm_gated_bwd": 0.0, "flash_attention_bwd": 0.0}
    rels = dict(errs)

    def keep(name, gap):
        errs[name] = max(errs[name], gap[0])
        rels[name] = max(rels[name], gap[1])

    ops.reset_counts()
    n_rwkv = n_ssd = 0
    for dtype in (torch.bfloat16, torch.float32):
        for B, S, H, K, V, planted in TRAIN_RWKV_CASES:
            what = (f"parity-train rwkv6_scan B={B} S={S} H={H} K={K} V={V} "
                    f"planted={planted} {dtype}")
            ins = rwkv_case(rng, dev, dtype, B, S, H, K, V, planted)
            cots = (torch.randn(B, S, H, V, device=dev),
                    torch.randn(B, H, K, V, device=dev))
            got = bwd_twice(what, ops.rwkv6_scan, ins, cots)
            want = grads_of(ref.rwkv6_scan, [t.float() for t in ins], cots)
            keep("rwkv6_scan_bwd", gaps_within(
                what, ("dr", "dk", "dv", "dw", "du", "dstate0"), got, want,
                SCAN_BWD_REL[dtype]))
            n_rwkv += 1
        for B, S, H, P, N in TRAIN_SSD_CASES:
            what = f"parity-train ssd_scan B={B} S={S} H={H} P={P} N={N} " \
                f"B/C {dtype}"
            ins = ssd_case(rng, dev, dtype, B, S, H, P, N)
            cots = (torch.randn(B, S, H, P, device=dev),
                    torch.randn(B, H, N, P, device=dev))
            got = bwd_twice(what, ops.ssd_scan, ins, cots)
            want = grads_of(ref.ssd_scan, [t.float() for t in ins], cots)
            keep("ssd_scan_bwd", gaps_within(
                what, ("dxdt", "dla", "dB", "dC", "dstate0"), got, want,
                SCAN_BWD_REL[dtype]))
            n_ssd += 1
    bf16 = torch.bfloat16
    for rows, d in TRAIN_GATED_CASES:
        what = f"parity-train gated_rmsnorm rows={rows} d={d} z bf16"
        y = torch.randn(rows, d, device=dev)
        z, g = (torch.randn(rows, d, device=dev).to(bf16) for _ in range(2))
        scale = 1 + 0.1 * torch.randn(d, device=dev)
        got = bwd_twice(what, ops.gated_rmsnorm, (y, z, scale), (g,))
        want = grads_of(ref.gated_rmsnorm, (y, z.float(), scale),
                        (g.float(),))
        keep("rmsnorm_gated_bwd", gaps_within(
            what, ("dy", "dz", "dscale"), got, want, TRAIN_NORM_TOL[bf16]))
        del y, z, g, got, want
    B, S, Hq, Hkv, D = TRAIN_FLASH_Z
    what = f"parity-train flash_attention B={B} S={S} Hq={Hq} Hkv={Hkv} " \
        f"D={D} causal bf16"
    q, g = (torch.randn(B, S, Hq, D, device=dev).to(bf16) for _ in range(2))
    k, v = (torch.randn(B, S, Hkv, D, device=dev).to(bf16)
            for _ in range(2))
    fwd_err = check("flash_attention", what, ops.flash_attention(q, k, v),
                    ref.flash_attention(q, k, v), bf16)
    got = bwd_twice(what, ops.flash_attention, (q, k, v), (g,))
    want = grads_of(ref.flash_attention, tuple(t.float() for t in (q, k, v)),
                    (g.float(),))
    keep("flash_attention_bwd", gaps_within(
        what, ("dq", "dk", "dv"), got, want, TRAIN_FLASH_REL[bf16]))
    del q, k, v, g, got, want
    counts = {k: c.kernel for k, c in ops.COUNTS.items() if c.kernel}
    n_gated = len(TRAIN_GATED_CASES)
    n_ssd_tc = len(TRAIN_SSD_CASES)        # the bf16 B/C calls
    want_counts = {
        "rwkv6_scan": 2 * n_rwkv, "rwkv6_scan_tc": 2 * n_rwkv,
        "rwkv6_scan_bwd": 2 * n_rwkv, "rwkv6_scan_bwd_tc": 2 * n_rwkv,
        "ssd_scan": 2 * n_ssd, "ssd_scan_tc": 2 * n_ssd_tc,
        "ssd_scan_bwd": 2 * n_ssd, "ssd_scan_bwd_tc": 2 * n_ssd_tc,
        "rmsnorm": 2 * n_gated, "rmsnorm_gated": 2 * n_gated,
        "rmsnorm_bwd": 2 * n_gated, "rmsnorm_gated_bwd": 2 * n_gated,
        "flash_attention": 3, "flash_attention_tc": 3,
        "flash_attention_bwd": 2, "flash_attention_bwd_tc": 2}
    if counts != want_counts or any(c.plain for c in ops.COUNTS.values()):
        raise AssertionError(f"parity-train (recurrent): launches {counts}; "
                             f"want {want_counts}, no plain call")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"parity-train: B4's backward at (B, S, H, K, V, planted) "
        f"{TRAIN_RWKV_CASES} with a nonzero state, B5's at (B, S, H, P, N) "
        f"{TRAIN_SSD_CASES}, r/k/v and B/C in bf16 and float32 (limits "
        f"{ {str(k): v for k, v in SCAN_BWD_REL.items()} }: summation order "
        f"for float32 inputs, one bf16 rounding of the gradient for bf16), "
        f"the gated norm's at (rows, d) {TRAIN_GATED_CASES} with bf16 z "
        f"(limit {TRAIN_NORM_TOL[bf16]}), B3 at head dim 112 "
        f"{TRAIN_FLASH_Z} bf16 causal (zero-padded to 128 on the tensor "
        f"cores: forward max abs {fwd_err:.3e}, limit "
        f"{TOL['flash_attention'][bf16]}; backward limit "
        f"{TRAIN_FLASH_REL[bf16]}), each against autograd through the "
        f"plain version in float32: max |d| over max(1, max |autograd|) "
        f"{rels}, max |d| {errs}; each backward run twice: the same bits; "
        f"launches {counts} (each case's forward and backward twice, the "
        f"forward once more alone for B3)")
    errs["flash_attention"] = fwd_err
    return errs


def recurrent_launches_wanted(cfg, steps: int) -> dict:
    """The kernels' launches in ``steps`` training steps of rwkv6 or zamba2
    under remat full: each recomputed block's forward twice, its backward
    once.  rwkv6: the wkv scan a layer (the tensor-core route at K = V =
    64, forward and backward), nothing else (its norms are LayerNorms,
    plain in both packages).  zamba2: a Mamba layer's norm (the first
    alone, the rest fused with the residual add), SSD scan (tensor cores
    both ways: bf16 B/C, N = P = 64) and gated norm; a segment's shared
    block (its two fused norms and B3 at D 112 on the tensor cores, not
    recomputed); the final norm, fused."""
    L = cfg.n_layers
    if cfg.family != "hybrid":
        return {"rwkv6_scan": 2 * L * steps, "rwkv6_scan_tc": 2 * L * steps,
                "rwkv6_scan_bwd": L * steps, "rwkv6_scan_bwd_tc": L * steps}
    seg = L // cfg.shared_attn_every
    per_step = {
        "ssd_scan": 2 * L, "ssd_scan_tc": 2 * L, "ssd_scan_bwd": L,
        "ssd_scan_bwd_tc": L,
        "rmsnorm": 4 * L + 2 * seg + 1,
        "rmsnorm_add": 2 * (L - 1) + 2 * seg + 1,
        "rmsnorm_gated": 2 * L,
        "rmsnorm_bwd": 2 * L + 2 * seg + 1,
        "rmsnorm_add_bwd": L - 1 + 2 * seg + 1,
        "rmsnorm_gated_bwd": L,
        "flash_attention": seg, "flash_attention_tc": seg,
        "flash_attention_bwd": seg, "flash_attention_bwd_tc": seg}
    return {k: v * steps for k, v in per_step.items()}


def grads_checksum(model, params, batch) -> list:
    """The loss's bits and each gradient leaf's sum of its float32 bit
    patterns (as int64) of one forward and backward: equal bits give
    equal sums, and two whole gradients need not be held at once."""
    from repro_torch.train.step import make_grads_fn
    loss, _, grads = make_grads_fn(model)(params, batch)
    out = [loss.reshape(1).view(torch.int32).item()]
    for g in tree_leaves(grads):
        out.append(g.view(torch.int32).sum(dtype=torch.int64).item())
    del grads
    return out


def phase_main_train_recurrent(dev, label: str, cfg, with_shapes: bool):
    """A recurrent family through ``Trainer`` at TRAIN_REC_B x TRAIN_S for
    TRAIN_REC_STEPS steps, float32 params and AdamW moments, bf16 compute,
    remat full, counts from 0.  Gates: every loss finite and the last below
    the first; the launches :func:`recurrent_launches_wanted` names, no
    other kernel, no plain version; two forward and backward passes from
    the final state on one batch the same bits (:func:`grads_checksum`).
    Prints the losses, a step's host-issued and profiled device ms by
    kernel group, tokens/s and the peak beside the state's bytes.  With
    ``with_shapes``, B2 and B3 held against their plain versions at every
    shape the steps called them at, forward and backward."""
    from repro_torch.data import SyntheticTask, make_data_iter
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg)
    n = TRAIN_REC_STEPS
    n_params = sum(int(np.prod(p.shape)) for p in tree_leaves(
        model.param_defs()))
    opt = AdamWConfig(peak_lr=TRAIN_LR, warmup_steps=1, decay_steps=n)
    task = SyntheticTask(cfg, batch=TRAIN_REC_B, seq_len=TRAIN_S)
    tr = Trainer(model, opt, TrainerConfig(steps=n, log_every=n),
                 make_data_iter(task, device=dev), device=dev, seed=0,
                 log=log)
    ops.reset_counts()
    shapes = KernelShapes() if with_shapes else None
    t0 = time.perf_counter()
    try:
        h = tr.fit()["history"]
    finally:
        if shapes is not None:
            shapes.stop()
    wall = time.perf_counter() - t0
    counts = {k: (c.kernel, c.plain) for k, c in ops.COUNTS.items()}
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in h]
    log(f"[train] {cfg.name} ({cfg.n_layers} layers): loss {losses[0]:.4f} "
        f"-> {losses[-1]:.4f} over {len(h)} steps; "
        f"stragglers={tr.stragglers}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: losses {losses}")
    want = recurrent_launches_wanted(cfg, n)
    check_train_launches(label, counts, want)
    host = float(np.median([m["step_time"] for m in h[2:]])) * 1e3
    state = tr.final_state
    batch = next(make_data_iter(task, device=dev, start_step=n))
    sums = [grads_checksum(model, state["params"], batch) for _ in range(2)]
    if sums[0] != sums[1]:
        raise AssertionError(f"{label}: two passes from one state differ "
                             f"(loss bits {sums[0][0]} / {sums[1][0]})")
    split = train_step_split(model, opt, state, batch)
    devt = split["device_ms"]
    state_bytes = n_params * 16
    per_step = {k: v // n for k, v in want.items()}
    log(f"{label}: {cfg.name} {cfg.n_layers} layers d {cfg.d_model}, "
        f"float32 weights and moments, {cfg.dtype} compute, remat "
        f"{cfg.remat}, batch {TRAIN_REC_B} x {TRAIN_S}, {n} steps in "
        f"{wall:.1f} s: losses {[round(x, 4) for x in losses]}; grad norms "
        f"{[round(m['grad_norm'], 3) for m in h]}; a step host-issued "
        f"{host:.1f} ms (median of steps 3-{n}), device {devt:.1f} ms (one "
        f"step profiled: card idle {max(0.0, 1 - devt / host):.1%}), "
        f"{TRAIN_REC_B * TRAIN_S / host * 1e3:.0f} tokens/s; "
        f"max_memory_allocated={peak} B against the state's {n_params} "
        f"params x 16 B = {state_bytes} B (float32 params, gradients, m, "
        f"v); launches a step {per_step}, all of {counts}; two passes from "
        f"the final state the same bits (loss and every gradient leaf's "
        f"checksum); a step after them: {split_line(split)}")
    del state, batch, tr
    gc.collect()
    torch.cuda.empty_cache()
    errs = shapes.parity(label, dev) if shapes is not None else {}
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": {k: counts[k][0] for k in want}, "host_ms": host,
            "device_ms": devt, "peak": peak, "state_bytes": state_bytes,
            "losses": losses, "split": split, "errs": errs}


def scan_bwd_cost(kind: str, B, S, H, K, V, in_bytes) -> tuple[int, int]:
    """(bytes, operations) of a scan's backward (``kind`` "rwkv6", or B5's
    with P and N in place of K and V).  Bytes: the inputs read
    once (r, k, v or B and C in their dtype; w, xdt, la, dy float32), the
    gradients written once in their inputs' dtypes.  Operations a state
    element and step: the state's step forward (2: the states are not
    kept), and for B4 dr, dk, dv, dw (2 each) and G's step (2); for B5 S_t
    (2), G += C dy (2), dC, dB, dxdt, dla (2 each) and G's decay (1)."""
    if kind == "rwkv6":
        elems = B * S * H
        reads = elems * ((2 * K + V) * in_bytes + K * 4 + V * 4)
        writes = elems * ((2 * K + V) * in_bytes + K * 4)
        return reads + writes, elems * K * V * 12
    nbytes = (2 * B * S * H * K * 4 + 2 * B * S * H * 4
              + 4 * B * S * V * in_bytes + B * S * H * K * 4)
    return nbytes, B * S * H * K * V * 15


def phase_timing_train_recurrent(dev, smi: str) -> dict:
    """timing-train's rows of the recurrent families: B4's backward at
    main-train-rwkv's shape, B5's at main-train-zamba's, the gated norm's
    at its (rows, d) and B3 at head dim 112 (main-train-zamba's shared
    block: B 4, S 2048, 32/32 heads, bf16, causal) forward and backward.
    Each kernel as device time of calls queued behind a spin, beside its
    bound and its plain version (autograd for the backwards; a scan's plain
    autograd on one batch row, timed by CUDA events around a host-paced
    call: its graph over 2048 steps at 4 rows would hold 21 and 60 GB);
    B3 also beside SDPA with the same mask and with ``is_causal``.  Each
    scan's backward on both routes in the same run: ``ms`` the
    chunk-parallel tensor-core route the training steps take,
    ``cuda_core_ms`` the CUDA-core route (``tensor_cores=False``).  No
    single PyTorch call computes a scan's or the gated norm's backward:
    their library time is None.  Each scan's backward at these shapes is
    also held against that plain autograd at SCAN_BWD_REL (bf16 inputs):
    row 0 of the B 4 call (B4's dr, dk, dv, dw; B5's dxdt, dla and dB, dC,
    which sum over every head of the row), and B4's du, a sum over the
    batch rows, from a call on row 0 alone; raises past the limit and
    returns the max abs gaps as ``max_abs_err``."""
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm import gated_rmsnorm_bwd_cuda
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_bwd_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda
    rng = np.random.default_rng(31)
    torch.manual_seed(31)
    bf16 = torch.bfloat16
    out = {}

    def plain_autograd(fn, ins, cot):
        """(ms, gradients) of the plain version's autograd."""
        leaves = [t.detach().float().requires_grad_(True) for t in ins]
        y = fn(*leaves)[0]
        grads = []

        def run():
            grads[:] = torch.autograd.grad(y, leaves, cot, retain_graph=True)
        ms = time_ms(run, iters=1, warmup=1)
        del y, leaves
        return ms, grads

    def s2048_gap(what, names, got, want) -> float:
        e, r = gaps_within(f"timing-train {what} (S {S}, against the plain "
                           "autograd)", names, got, want, SCAN_BWD_REL[bf16])
        log(f"timing-train {what}: {', '.join(names)} against the plain "
            f"autograd at S {S}: max |d| {e:.3e}, max |d| over max(1, max "
            f"|autograd|) {r:.3e} (limit {SCAN_BWD_REL[bf16]})")
        return e

    rcfg = get_config(TRAIN_RWKV_ARCH)
    B, S, H, K = TRAIN_REC_B, TRAIN_S, rcfg.rwkv_heads, rcfg.rwkv_head_dim
    routes = {True: "tensor cores", False: "CUDA cores"}
    r, k, v, w, u, _ = rwkv_case(rng, dev, bf16, B, S, H, K, K)
    gy = torch.randn(B, S, H, K, device=dev)
    ms = {tc: queued_ms(lambda: rwkv6_scan_bwd_cuda(
        r, k, v, w, u, None, gy, tensor_cores=tc), iters=3) for tc in routes}
    plain, want = plain_autograd(ref.rwkv6_scan,
                                 (r[:1], k[:1], v[:1], w[:1], u), gy[:1])
    err = 0.0
    for tc, tag in routes.items():
        got = rwkv6_scan_bwd_cuda(r, k, v, w, u, None, gy, tensor_cores=tc)
        err = max(err, s2048_gap(
            f"rwkv6_scan_bwd ({tag}) B={B} H={H} K=V={K}, row 0",
            ("dr", "dk", "dv", "dw"), [g[:1] for g in got[:4]], want[:4]))
        got = rwkv6_scan_bwd_cuda(r[:1], k[:1], v[:1], w[:1], u, None,
                                  gy[:1], tensor_cores=tc)
        err = max(err, s2048_gap(
            f"rwkv6_scan_bwd ({tag}) B=1 H={H} K=V={K}", ("du",), got[4:5],
            want[4:5]))
        del got
    del want
    cost = scan_bwd_cost("rwkv6", B, S, H, K, K, 2)
    b, by = bound(*cost, "tf32")
    f32_b, f32_by = bound(*cost, torch.float32)
    out["rwkv6_scan_bwd"] = dict(
        ms=ms[True], cuda_core_ms=ms[False], plain_ms=plain,
        plain_shape=[1, S, H, K, K], library_ms=None, bound_ms=b,
        bound_by=by, bound_f32_ms=f32_b, max_abs_err=err,
        shape=f"B={B} S={S} H={H} K=V={K} r/k/v bf16, no state", card=smi)
    log(f"timing rwkv6_scan_bwd [B={B} S={S} H={H} K=V={K} r/k/v bf16; "
        f"{smi}]: device kernel {ms[True]:.4f} ms (the chunk-parallel "
        f"tensor-core route, six launches; the CUDA-core route "
        f"{ms[False]:.4f} ms, two launches, {ms[False] / ms[True]:.2f}x), "
        f"plain (autograd, float32, B 1) {plain:.2f} ms, no single PyTorch "
        f"call, bound {b:.4f} ms ({by}, operations at the TF32 peak; at "
        f"the float32 CUDA-core peak {f32_b:.4f} ms, {f32_by})")
    del r, k, v, w, u, gy
    zcfg = get_config(TRAIN_ZAMBA_ARCH)
    H, P, N = zcfg.ssm_heads, zcfg.ssm_head_dim, zcfg.ssm_state
    xdt, la, bm, cm, _ = ssd_case(rng, dev, bf16, B, S, H, P, N)
    gy = torch.randn(B, S, H, P, device=dev)
    ms = {tc: queued_ms(lambda: ssd_scan_bwd_cuda(
        xdt, la, bm, cm, None, gy, tensor_cores=tc), iters=3)
        for tc in routes}
    plain, want = plain_autograd(ref.ssd_scan,
                                 (xdt[:1], la[:1], bm[:1], cm[:1]), gy[:1])
    err = 0.0
    for tc, tag in routes.items():
        got = ssd_scan_bwd_cuda(xdt, la, bm, cm, None, gy, tensor_cores=tc)
        err = max(err, s2048_gap(
            f"ssd_scan_bwd ({tag}) B={B} H={H} P={P} N={N}, row 0",
            ("dxdt", "dla", "dB", "dC"), [g[:1] for g in got[:4]], want))
        del got
    del want
    cost = scan_bwd_cost("ssd", B, S, H, P, N, 2)
    b, by = bound(*cost, "tf32")
    f32_b, f32_by = bound(*cost, torch.float32)
    out["ssd_scan_bwd"] = dict(
        ms=ms[True], cuda_core_ms=ms[False], plain_ms=plain,
        plain_shape=[1, S, H, P, N], library_ms=None, bound_ms=b,
        bound_by=by, bound_f32_ms=f32_b, max_abs_err=err,
        shape=f"B={B} S={S} H={H} P={P} N={N} B/C bf16, no state", card=smi)
    log(f"timing ssd_scan_bwd [B={B} S={S} H={H} P={P} N={N} B/C bf16; "
        f"{smi}]: device kernel {ms[True]:.4f} ms (the chunk-parallel "
        f"tensor-core route, five launches; the CUDA-core route "
        f"{ms[False]:.4f} ms, two launches, {ms[False] / ms[True]:.2f}x), "
        f"plain (autograd, float32, B 1) {plain:.2f} ms, no single PyTorch "
        f"call, bound {b:.4f} ms ({by}, operations at the TF32 peak; at "
        f"the float32 CUDA-core peak {f32_b:.4f} ms, {f32_by})")
    del xdt, la, bm, cm, gy
    rows, d = TRAIN_GATED_CASES[0]
    y = torch.randn(rows, d, device=dev)
    z, g = (torch.randn(rows, d, device=dev).to(bf16) for _ in range(2))
    scale = 1 + 0.1 * torch.randn(d, device=dev)
    leaves = [t.detach().clone().requires_grad_(True) for t in (y, z, scale)]
    plain_out = ref.gated_rmsnorm(*leaves)
    t = {"kernel": queued_ms(lambda: gated_rmsnorm_bwd_cuda(y, z, g, scale)),
         "plain": queued_ms(lambda: torch.autograd.grad(
             plain_out, leaves, g, retain_graph=True))}
    # y (float32), z and dout read; dy (float32) and dz written; the scale
    b, by = bound(rows * d * (4 + 2 + 2 + 4 + 2) + 2 * 4 * d, 20 * rows * d,
                  bf16)
    out["rmsnorm_gated_bwd"] = dict(
        ms=t["kernel"], plain_ms=t["plain"], library_ms=None, bound_ms=b,
        bound_by=by, shape=[rows, d, "z bf16, y float32, float32 scale"],
        card=smi)
    log(f"timing rmsnorm_gated_bwd [rows={rows} d={d}, y float32, z bf16, "
        f"float32 scale; {smi}]: device kernel {t['kernel']:.4f} ms (two "
        f"launches), plain (autograd, bf16 as the model runs it) "
        f"{t['plain']:.4f} ms, no single PyTorch call, bound {b:.4f} ms "
        f"({by})")
    del y, z, g, scale, leaves, plain_out
    gc.collect()
    torch.cuda.empty_cache()
    Hq, Hkv, D = zcfg.n_heads, zcfg.n_kv_heads, zcfg.head_dim
    q = torch.randn(B, S, Hq, D, device=dev).to(bf16)
    k, v = (torch.randn(B, S, Hkv, D, device=dev).to(bf16) for _ in range(2))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    mask = sdpa_mask(S, None, dev)
    pairs = window_pairs(S, None)
    b, by = bound((2 * q.numel() + k.numel() + v.numel()) * 2,
                  4 * D * Hq * B * pairs, bf16)
    t = {what: device_ms([fn]) for what, fn in (
        ("kernel", lambda: ops.flash_attention(q, k, v)),
        ("plain", lambda: ref.flash_attention(q, k, v)),
        ("library", lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask)),
        ("library_causal", lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)))}
    out["flash_attention_z"] = {
        "shape": [B, S, S, Hq, Hkv, D, True, None], "ms": t["kernel"],
        "plain_ms": t["plain"], "library_ms": t["library"],
        "library_causal_ms": t["library_causal"], "bound_ms": b,
        "bound_by": by, "cores": "tensor (D 112 zero-padded to 128)",
        "card": smi}
    log(f"timing flash_attention zamba2 [B={B} S={S} Hq={Hq} Hkv={Hkv} "
        f"D={D} bf16 causal, tensor-core route at D 128 zero-padded; "
        f"{smi}]: device kernel {t['kernel']:.4f} ms (the pads and the "
        f"slice included), plain {t['plain']:.4f} ms, SDPA (same mask) "
        f"{t['library']:.4f} ms, SDPA is_causal {t['library_causal']:.4f} "
        f"ms, bound {b:.4f} ms ({by}, at D 112)")
    del q, k, v, qt, kt, vt, mask
    gc.collect()
    torch.cuda.empty_cache()
    return out


def teacher_forcing(model, params, prompts, toks):
    """(decode logits, prefill logits) of the last generated token: a
    prefill of the prompts, a decode step a token over ``toks[:, :-1]``,
    the last one's logits; and the last position of a prefill of the
    prompts and ``toks[:, :-1]`` together."""
    B, S = prompts.shape
    new = toks.shape[1]
    max_len = S + new
    seq = torch.cat([prompts, toks.to(prompts.dtype)], dim=1)
    cache, _ = model.prefill(params, prompts, max_len)
    for i in range(new - 1):
        logits = model.decode_step(params, cache, seq[:, S + i:S + i + 1],
                                   S + i)
    _, hidden = model.prefill(params, seq[:, :-1], max_len)
    want = model.lm_head(params, hidden[:, -1:])
    return logits[:, 0, :model.cfg.vocab], want[:, 0, :model.cfg.vocab]


def tf_gap(got, want) -> tuple[float, int, float]:
    """(max |d logit|, rows whose argmax differs, the smallest top-2 margin
    of the prefill's logits among them)."""
    gap = (got - want).abs().max().item()
    diff = (got.argmax(-1) != want.argmax(-1)).nonzero().flatten().tolist()
    top2 = want.topk(2, dim=-1).values
    margins = (top2[:, 0] - top2[:, 1]).tolist()
    return gap, len(diff), min((margins[i] for i in diff), default=0.0)


def phase_main_gemma3(dev) -> dict:
    """Full-width, full-depth gemma3-4b as aligned batches (GEMMA_BATCHES,
    greedy to GEMMA_NEW), counts from 0 each: B3 34 launches a prefill (29
    windowed, 5 global, all on the tensor cores), none at decode; B2
    qwen_norms a prefill or step; nothing else and no plain version; B3
    and B2 held against their plain versions at every shape the batch
    called them at (:class:`KernelShapes`).  Teacher forcing gated at full
    depth in bf16 and at GEMMA_GATE_DEPTH layers in float32.  Each batch's
    prefill and decode step timed."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(GEMMA_ARCH)
    model = build_model(cfg)
    L = cfg.n_layers
    glob, loc = T.layer_groups(cfg)
    params = model.init(0, device=dev)
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    rng = np.random.default_rng(25)
    out = {"launches": {}, "steps": {}, "errs": {}}
    for rows, S in GEMMA_BATCHES:
        label = f"{rows} x {S}"
        prompts = torch.tensor(rng.integers(0, cfg.vocab, (rows, S))
                               .astype(np.int32), device=dev)
        ops.reset_counts()
        shapes = KernelShapes()
        try:
            toks, t_pre, t_dec = greedy_aligned(model, params, prompts,
                                                GEMMA_NEW, S + GEMMA_NEW)
        finally:
            shapes.stop()
        counts = {k: (c.kernel, c.plain) for k, c in ops.COUNTS.items()}
        windowed, global_ = (shapes.flash_calls(w) for w in (True, False))
        if toks.shape != (rows, GEMMA_NEW) or not (
                (toks >= 0) & (toks < cfg.vocab)).all():
            raise AssertionError(f"main-gemma3 {label}: tokens {toks}")
        if ((windowed, global_) != (len(loc), len(glob))
                or counts["flash_attention"] != (L, 0)
                or counts["flash_attention_tc"] != (L, 0)
                or any(counts[k][0] for k in counts if k not in (
                    "flash_attention", "flash_attention_tc", "rmsnorm",
                    "rmsnorm_add"))):
            raise AssertionError(
                f"main-gemma3 {label}: B3 windowed {windowed} global "
                f"{global_} (want {len(loc)} and {len(glob)}); launches "
                f"{counts}")
        check_norm_counts(f"main-gemma3 {label}", counts, GEMMA_NEW,
                          qwen_norms(cfg))
        out["launches"][label] = {k: counts[k][0] for k in (
            "flash_attention", "flash_attention_tc", "rmsnorm",
            "rmsnorm_add")}
        out["launches"][label]["flash_attention_windowed"] = windowed
        for name, e in shapes.parity(f"main-gemma3 {label}", dev).items():
            out["errs"][name] = max(out["errs"].get(name, 0.0), e)
        got, want = teacher_forcing(model, params, prompts,
                                    torch.tensor(toks, device=dev))
        gap, flips, margin = tf_gap(got, want)
        if gap > GEMMA_BF16_TOL or (flips and margin >= NEAR_TIE):
            raise AssertionError(
                f"main-gemma3 {label}: teacher forcing max |d logit| {gap} "
                f"(limit {GEMMA_BF16_TOL}), argmax differs in {flips} rows "
                f"(top-2 margin {margin}, near-tie below {NEAR_TIE})")
        # one prefill and one decode step, host-issued and device time
        state, _ = model.prefill(params, prompts, S + GEMMA_NEW)
        tok = torch.tensor(toks[:, :1], device=dev, dtype=torch.int32)
        steps = {}
        for name, fn in (
                ("prefill", lambda: model.prefill(params, prompts,
                                                  S + GEMMA_NEW)),
                ("decode", lambda: model.decode_step(params, state, tok, S))):
            host = time_ms(fn, iters=3, warmup=1)
            devt, _ = profiled_ms(fn, iters=2)
            steps[name] = {"host_ms": host, "device_ms": devt,
                           "idle": max(0.0, 1 - devt / host)}
        out["steps"][label] = steps
        log(f"main-gemma3 {label}: {GEMMA_ARCH} {L} layers ({len(loc)} "
            f"windowed of {cfg.local_window}, {len(glob)} global) d "
            f"{cfg.d_model} {cfg.n_heads}/{cfg.n_kv_heads} heads of "
            f"{cfg.head_dim} vocab {cfg.vocab} {cfg.dtype}, greedy to "
            f"{GEMMA_NEW}: prefill {t_pre * 1e3:.1f} ms with the first token, "
            f"{GEMMA_NEW - 1} decode steps {t_dec * 1e3:.1f} ms; B3 "
            f"{windowed} windowed + {global_} global launches a "
            f"prefill, all on the tensor cores; launches {counts}; "
            f"teacher forcing (the last decode step against a prefill of "
            f"the same tokens): max |d logit| {gap:.4f} (limit "
            f"{GEMMA_BF16_TOL}), argmax differs in {flips} of {rows} rows "
            f"(smallest top-2 margin there {margin:.4f}); a prefill "
            f"host-issued {steps['prefill']['host_ms']:.2f} ms, device "
            f"{steps['prefill']['device_ms']:.2f} ms (idle "
            f"{steps['prefill']['idle']:.1%}); a decode step host-issued "
            f"{steps['decode']['host_ms']:.2f} ms, device "
            f"{steps['decode']['device_ms']:.2f} ms (idle "
            f"{steps['decode']['idle']:.1%})")
        del state, prompts
    peak = torch.cuda.max_memory_allocated()
    log(f"main-gemma3: {weights} B of weights, max_memory_allocated={peak} B")
    # the gates: the weights cut to their first GEMMA_GATE_DEPTH layers
    cut_cfg = cfg.replace(n_layers=GEMMA_GATE_DEPTH)
    cut_params = {k: v for k, v in params.items() if k != "blocks"}
    cut_params["blocks"] = tree_map(lambda t: t[:GEMMA_GATE_DEPTH],
                                    params["blocks"])
    del params
    gates = []
    p = tree_map(lambda t: t.float(), cut_params)
    m = build_model(cut_cfg.replace(dtype="float32"))
    for rows, S in GEMMA_BATCHES:
        prompts = torch.tensor(rng.integers(0, cfg.vocab, (rows, S))
                               .astype(np.int32), device=dev)
        toks, _, _ = greedy_aligned(m, p, prompts, GEMMA_NEW, S + GEMMA_NEW)
        got, want = teacher_forcing(m, p, prompts,
                                    torch.tensor(toks, device=dev))
        gap, flips, margin = tf_gap(got, want)
        if gap > GEMMA_F32_TOL or (flips and margin >= NEAR_TIE):
            raise AssertionError(
                f"main-gemma3 gate float32 {rows} x {S}: max |d logit| {gap} "
                f"(limit {GEMMA_F32_TOL}), argmax differs in {flips} rows "
                f"(top-2 margin {margin}, near-tie below {NEAR_TIE})")
        gates.append(f"float32 {rows} x {S} {gap:.2e} (limit "
                     f"{GEMMA_F32_TOL}), argmax flips {flips}")
    del p
    log(f"main-gemma3 gates at the first {GEMMA_GATE_DEPTH} layers (5 "
        f"windowed + 1 global): teacher forcing, the last of {GEMMA_NEW} "
        f"greedy tokens decoded past the ring's wrap against a prefill of "
        f"the same tokens: " + "; ".join(gates))
    del cut_params
    gc.collect()
    torch.cuda.empty_cache()
    out["peak"] = peak
    return out


def window_pairs(S: int, window) -> int:
    """(query, key) pairs a causal row set sees, windowed or not."""
    if window is None:
        return S * (S + 1) // 2
    return sum(min(i + 1, window) for i in range(S))


def sdpa_mask(S: int, window, dev):
    i = torch.arange(S, device=dev)[:, None]
    j = torch.arange(S, device=dev)[None, :]
    ok = j <= i
    if window is not None:
        ok &= (i - j) < window
    return ok


def optional_ms(what: str, fn):
    """``fn()``, or None (logged) where this torch's SDPA refuses the call:
    a yardstick that is not there is recorded as absent, never guessed."""
    try:
        return fn()
    except (RuntimeError, TypeError, NotImplementedError) as e:
        log(f"{what}: not run ({type(e).__name__}: {str(e)[:160]})")
        return None


def sp_pairs(Sq: int, off: int) -> int:
    """(query, key) pairs a causal block of Sq queries at ``off`` sees."""
    return Sq * off + Sq * (Sq + 1) // 2


def phase_timing_train(dev, smi: str) -> dict:
    """B3 forward at gemma3's prefill shapes (S 2048, window 1024 and
    global); B3's and B2's backward at the training shapes.  Each beside
    its plain version, one PyTorch yardstick (SDPA with the same mask,
    SDPA's backward, autograd through ``F.rms_norm`` with the same float32
    scale) and its bound; an unwindowed B3 row also beside SDPA with
    ``is_causal=True`` (an explicit mask keeps SDPA off its flash backend,
    so this is the stronger yardstick).  The forwards in device time of a
    replayed CUDA graph; the backwards, whose plain and yardstick runs are
    autograd calls, in device time of calls queued behind a spin
    (:func:`queued_ms`)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        backward_tensor_core_route, flash_attention_bwd_cuda,
        flash_attention_cuda, flash_attention_plain, tensor_core_route)
    from repro_torch.kernels.rmsnorm import (add_rmsnorm_plain,
                                             rmsnorm_bwd_cuda, rmsnorm_plain)
    torch.manual_seed(3)
    bf16 = torch.bfloat16
    out = {"flash_attention": {}, "flash_attention_bwd": {},
           "rmsnorm_bwd": {}}
    gcfg = get_config(GEMMA_ARCH)
    B, S, Hq, Hkv, D = 4, 2048, gcfg.n_heads, gcfg.n_kv_heads, gcfg.head_dim
    q = torch.randn(B, S, Hq, D, device=dev).to(bf16)
    k, v = (torch.randn(B, S, Hkv, D, device=dev).to(bf16) for _ in range(2))
    for window in (gcfg.local_window, None):
        mask = sdpa_mask(S, window, dev)
        label = f"gemma3 window={window}"
        b, by = bound((2 * q.numel() + k.numel() + v.numel()) * 2,
                      4 * D * Hq * B * window_pairs(S, window), bf16)
        fns = [("kernel", lambda: ops.flash_attention(q, k, v, window=window)),
               ("plain", lambda: ref.flash_attention(q, k, v, window=window)),
               ("library", lambda: F.scaled_dot_product_attention(
                   q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                   attn_mask=mask, enable_gqa=True))]
        if window is None:
            fns.append(("library_causal", lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True)))
        t = {what: device_ms([fn]) for what, fn in fns}
        out["flash_attention"][label] = {
            "shape": [B, S, S, Hq, Hkv, D, True, window], "ms": t["kernel"],
            "plain_ms": t["plain"], "library_ms": t["library"],
            "bound_ms": b, "bound_by": by,
            **({"library_causal_ms": t["library_causal"]}
               if window is None else {})}
        route = "tensor-core" if tensor_core_route(q) else "CUDA-core"
        causal_lib = (f", SDPA is_causal {t['library_causal']:.4f} ms"
                      if window is None else "")
        log(f"timing flash_attention {label} [B={B} S={S} Hq={Hq} Hkv={Hkv} "
            f"D={D} bf16, {route} route]: device kernel {t['kernel']:.4f} "
            f"ms, plain {t['plain']:.4f} ms, SDPA (same mask) "
            f"{t['library']:.4f} ms{causal_lib}, bound {b:.4f} ms ({by})")
    del q, k, v
    tcfg = get_config(TRAIN_ARCH)
    # the sequence-parallel block: B3 forward and backward with a query
    # offset beside SDPA with the same mask (explicit, and as
    # causal_lower_right, which keeps SDPA on its fused kernels)
    from torch.nn.attention.bias import causal_lower_right
    B, Sq, Sk, off = SP_BLOCK
    Hq, Hkv, D = tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim
    q, g = (torch.randn(B, Sq, Hq, D, device=dev).to(bf16) for _ in range(2))
    k, v = (torch.randn(B, Sk, Hkv, D, device=dev).to(bf16)
            for _ in range(2))
    mask = (torch.arange(Sk, device=dev)[None, :]
            <= off + torch.arange(Sq, device=dev)[:, None])
    lower_right = causal_lower_right(Sq, Sk)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pairs = sp_pairs(Sq, off)
    b, by = bound((2 * q.numel() + k.numel() + v.numel()) * 2,
                  4 * D * Hq * B * pairs, bf16)
    t = {what: device_ms([fn]) for what, fn in (
        ("kernel", lambda: ops.flash_attention(q, k, v, q_offset=off)),
        ("plain", lambda: ref.flash_attention(q, k, v, q_offset=off)),
        ("library", lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)))}
    t["library_causal"] = optional_ms("SDPA causal_lower_right", lambda: (
        device_ms([lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=lower_right, enable_gqa=True)])))
    out["flash_attention"]["sp_block"] = {
        "shape": [B, Sq, Sk, Hq, Hkv, D, True, None, off], "ms": t["kernel"],
        "plain_ms": t["plain"], "library_ms": t["library"],
        "library_causal_ms": t["library_causal"], "bound_ms": b,
        "bound_by": by, "card": smi}
    log(f"timing flash_attention sp-block [B={B} Sq={Sq} Sk={Sk} "
        f"q_offset={off} Hq={Hq} Hkv={Hkv} D={D} bf16, tensor-core route; "
        f"{smi}]: device kernel {t['kernel']:.4f} ms, plain "
        f"{t['plain']:.4f} ms, SDPA (same mask) {t['library']:.4f} ms, SDPA "
        f"causal_lower_right {t['library_causal']} ms, bound {b:.4f} ms "
        f"({by})")
    o, lse = flash_attention_cuda(q, k, v, q_offset=off, with_lse=True)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    plain_out = flash_attention_plain(*leaves, q_offset=off)
    lib_leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in lib_leaves), attn_mask=mask,
        enable_gqa=True)
    lr_leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    lr_out = optional_ms("SDPA causal_lower_right", lambda: (
        F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in lr_leaves), attn_mask=lower_right,
            enable_gqa=True)))
    gt = g.transpose(1, 2)
    b, by = bound((2 * q.numel() + 2 * k.numel() + 2 * v.numel()
                   + 2 * o.numel()) * 2, 10 * D * Hq * B * pairs, bf16)
    t = {"kernel": queued_ms(lambda: flash_attention_bwd_cuda(
             q, k, v, o, g, q_offset=off, lse=lse), iters=5),
         "plain": queued_ms(lambda: torch.autograd.grad(
             plain_out, leaves, g, retain_graph=True), iters=5),
         "library": queued_ms(lambda: torch.autograd.grad(
             lib_out, lib_leaves, gt, retain_graph=True)),
         "library_causal": None if lr_out is None else queued_ms(
             lambda: torch.autograd.grad(lr_out, lr_leaves, gt,
                                         retain_graph=True))}
    out["flash_attention_bwd"]["sp_block"] = {
        "shape": [B, Sq, Sk, Hq, Hkv, D, True, None, off], "ms": t["kernel"],
        "plain_ms": t["plain"], "library_ms": t["library"],
        "library_causal_ms": t["library_causal"], "bound_ms": b,
        "bound_by": by, "cores": "tensor", "card": smi}
    log(f"timing flash_attention_bwd sp-block [B={B} Sq={Sq} Sk={Sk} "
        f"q_offset={off} Hq={Hq} Hkv={Hkv} D={D} bf16, tensor-core route; "
        f"{smi}]: device kernel {t['kernel']:.4f} ms, plain (autograd, "
        f"float32) {t['plain']:.4f} ms, SDPA's backward (same mask) "
        f"{t['library']:.4f} ms, causal_lower_right {t['library_causal']} "
        f"ms, bound {b:.4f} ms ({by})")
    del (q, k, v, g, o, lse, leaves, plain_out, lib_leaves, lib_out,
         lr_leaves, lr_out, qt, kt, vt, gt, mask)
    gc.collect()
    torch.cuda.empty_cache()
    mcfg = get_config(MOE_ARCH)
    zcfg = get_config(TRAIN_ZAMBA_ARCH)
    for label, (B, S, Hq, Hkv, D, window) in (
            ("train", (TRAIN_B, TRAIN_S, tcfg.n_heads, tcfg.n_kv_heads,
                       tcfg.head_dim, None)),
            ("gemma3", (1, 2048, gcfg.n_heads, gcfg.n_kv_heads,
                        gcfg.head_dim, gcfg.local_window)),
            ("train_moe", (TRAIN_MOE_B, TRAIN_S, mcfg.n_heads,
                           mcfg.n_kv_heads, mcfg.head_dim, None)),
            ("train_zamba", (TRAIN_REC_B, TRAIN_S, zcfg.n_heads,
                             zcfg.n_kv_heads, zcfg.head_dim, None))):
        q, g = (torch.randn(B, S, Hq, D, device=dev).to(bf16)
                for _ in range(2))
        k, v = (torch.randn(B, S, Hkv, D, device=dev).to(bf16)
                for _ in range(2))
        tc = backward_tensor_core_route(q)
        o, lse = (flash_attention_cuda(q, k, v, window=window, with_lse=True)
                  if tc else (ops.flash_attention(q, k, v, window=window),
                              None))
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        plain_out = flash_attention_plain(*leaves, window=window)
        lib_leaves = [t.detach().clone().requires_grad_(True)
                      for t in (q, k, v)]
        mask = sdpa_mask(S, window, dev)
        lib_out = F.scaled_dot_product_attention(
            *(t.transpose(1, 2) for t in lib_leaves), attn_mask=mask,
            enable_gqa=True)
        gt = g.transpose(1, 2)
        pairs = window_pairs(S, window)
        b, by = bound((2 * q.numel() + 2 * k.numel() + 2 * v.numel()
                       + 2 * o.numel()) * 2, 10 * D * Hq * B * pairs, bf16)
        if window is None:
            causal_leaves = [t.detach().clone().requires_grad_(True)
                             for t in (q, k, v)]
            causal_out = F.scaled_dot_product_attention(
                *(t.transpose(1, 2) for t in causal_leaves), is_causal=True,
                enable_gqa=True)
        t = {"kernel": queued_ms(lambda: flash_attention_bwd_cuda(
                 q, k, v, o, g, window=window, lse=lse), iters=5),
             "plain": queued_ms(lambda: torch.autograd.grad(
                 plain_out, leaves, g, retain_graph=True), iters=5),
             "library": queued_ms(lambda: torch.autograd.grad(
                 lib_out, lib_leaves, gt, retain_graph=True))}
        if window is None:
            t["library_causal"] = queued_ms(lambda: torch.autograd.grad(
                causal_out, causal_leaves, gt, retain_graph=True))
            del causal_leaves, causal_out
        out["flash_attention_bwd"][label] = {
            "shape": [B, S, Hq, Hkv, D, True, window], "ms": t["kernel"],
            "plain_ms": t["plain"], "library_ms": t["library"],
            "bound_ms": b, "bound_by": by,
            "cores": "tensor" if tc else "CUDA",
            **({"library_causal_ms": t["library_causal"]}
               if window is None else {})}
        causal_lib = (f", SDPA's backward with is_causal "
                      f"{t['library_causal']:.4f} ms" if window is None
                      else "")
        log(f"timing flash_attention_bwd {label} [B={B} S={S} Hq={Hq} "
            f"Hkv={Hkv} D={D} window={window} bf16, "
            f"{'tensor' if tc else 'CUDA'}-core route]: device kernel "
            f"{t['kernel']:.4f} ms, plain (autograd, float32) "
            f"{t['plain']:.4f} ms, SDPA's backward (same mask) "
            f"{t['library']:.4f} ms{causal_lib}, bound {b:.4f} ms ({by}; its "
            f"operations: 5 products of the forward's size)")
        del q, k, v, g, o, lse, leaves, plain_out, lib_leaves, lib_out
        gc.collect()
        torch.cuda.empty_cache()
    L_rows = TRAIN_B * TRAIN_S
    for label, rows, d, add in (
            ("ln", L_rows, tcfg.d_model, False),
            ("add_ln", L_rows, tcfg.d_model, True),
            ("q_norm", L_rows * tcfg.n_heads, tcfg.head_dim, False),
            ("k_norm", L_rows * tcfg.n_kv_heads, tcfg.head_dim, False)):
        x, dl, dy, ds = (torch.randn(rows, d, device=dev).to(bf16)
                         for _ in range(4))
        scale = 1 + 0.1 * torch.randn(d, device=dev)
        dsa = ds if add else None
        cots = (ds, dy) if add else (dy,)
        inputs = (x, dl, scale) if add else (x, scale)
        leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
        plain_out = (add_rmsnorm_plain(*leaves) if add
                     else rmsnorm_plain(*leaves))
        lib_leaves = [t.detach().clone().requires_grad_(True)
                      for t in inputs]
        if add:
            s_lib = lib_leaves[0] + lib_leaves[1]
            lib_out = (s_lib, F.rms_norm(s_lib, (d,), weight=lib_leaves[2],
                                         eps=1e-6))
        else:
            lib_out = F.rms_norm(lib_leaves[0], (d,), weight=lib_leaves[1],
                                 eps=1e-6)
        # the kernel reads the rows, dy (and ds) and the scale, and
        # writes dx and dscale
        n_in = 3 if add else 2
        b, by = bound(rows * d * 2 * (n_in + 1) + 2 * 4 * d,
                      8 * rows * d, bf16)
        # F.rms_norm's fused backward takes only a scale of the rows'
        # dtype: a bf16 scale, for the speed it reaches, not the yardstick
        lib16 = [x.detach().clone().requires_grad_(True),
                 scale.to(bf16).requires_grad_(True)]
        out16 = F.rms_norm(lib16[0], (d,), weight=lib16[1], eps=1e-6)
        t = {"kernel": queued_ms(lambda: rmsnorm_bwd_cuda(x, dy, dsa, scale)),
             "plain": queued_ms(lambda: torch.autograd.grad(
                 plain_out, leaves, cots, retain_graph=True)),
             "library": queued_ms(lambda: torch.autograd.grad(
                 lib_out, lib_leaves, cots, retain_graph=True)),
             "library_bf16": queued_ms(lambda: torch.autograd.grad(
                 out16, lib16, dy, retain_graph=True))}
        out["rmsnorm_bwd"][label] = {
            "shape": [rows, d, add], "ms": t["kernel"],
            "plain_ms": t["plain"], "library_ms": t["library"],
            "library_bf16_scale_ms": t["library_bf16"],
            "bound_ms": b, "bound_by": by}
        log(f"timing rmsnorm_bwd {label} [rows={rows} d={d} bf16, float32 "
            f"scale, {'with' if add else 'no'} sum gradient]: device kernel "
            f"{t['kernel']:.4f} ms (two launches), plain (autograd) "
            f"{t['plain']:.4f} ms, F.rms_norm's backward (the same float32 "
            f"scale{', the add before it' if add else ''}) "
            f"{t['library']:.4f} ms (with a bf16 scale, its fused kernel, "
            f"no add: {t['library_bf16']:.4f} ms), bound {b:.4f} ms ({by})")
        del x, dl, dy, ds, leaves, plain_out, lib_leaves, lib_out, lib16, out16
    gc.collect()
    torch.cuda.empty_cache()
    return out


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
    # the backward kernels of training: the reference differentiates its
    # jnp paths (no Pallas kernel has a VJP), so each names the TPU kernel
    # whose port it differentiates
    "rmsnorm_bwd": ("src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:38 (its backward)"),
    "flash_attention_bwd": (
        "src/repro_torch/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:113 (its backward)"),
    "rmsnorm_gated_bwd": (
        "src/repro_torch/csrc/rmsnorm.cu",
        "src/repro/kernels/rmsnorm.py:38 (its backward, Mamba-2's gated "
        "variant)"),
    "rwkv6_scan_bwd": ("src/repro_torch/csrc/rwkv6_scan.cu",
                       "src/repro/kernels/rwkv6_scan.py:82 (its backward)"),
    "ssd_scan_bwd": ("src/repro_torch/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan.py:99 (its backward)"),
}


# the CUDA kernels behind each wrapper that has more than one: its routes'
# kernels, in launch order
DEVICE_KERNELS = {
    "rwkv6_scan": ["rwkv6_chunk_state_kernel", "chunk_pass_kernel",
                   "rwkv6_chunk_out_kernel", "rwkv6_scan_kernel"],
    "ssd_scan": ["ssd_seg_state_kernel", "ssd_seg_out_kernel",
                 "ssd_scan_kernel"],
    "rmsnorm_bwd": ["rmsnorm_bwd_kernel", "rmsnorm_bwd_reduce_kernel"],
    "rmsnorm_gated_bwd": ["rmsnorm_bwd_kernel", "rmsnorm_bwd_reduce_kernel"],
    "rwkv6_scan_bwd": ["rwkv6_chunk_state_kernel", "chunk_pass_kernel",
                       "rwkv6_chunk_bwd_kernel", "rwkv6_scan_bwd_du_kernel",
                       "rwkv6_scan_bwd_kernel"],
    "ssd_scan_bwd": ["ssd_bwd_chunk_state_kernel", "chunk_pass_kernel",
                     "ssd_chunk_bwd_kernel", "ssd_scan_bwd_bc_kernel",
                     "ssd_scan_bwd_kernel"],
    "flash_attention": ["flash_attention_tc_kernel",
                        "flash_attention_kernel"],
    "flash_attention_bwd": ["fa_bwd_delta_kernel", "fa_bwd_dq_tc_kernel",
                            "fa_bwd_dkdv_tc_kernel", "fa_bwd_dq_kernel",
                            "fa_bwd_dkdv_kernel"],
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
    # three (the pass shared with the SSD's backward); the SSD kernels: the
    # CUDA-core one at N = P = 64, the tensor-core route's two; the scan
    # backwards' on both routes
    for line in (ptxas_report("flash_attention_tc_kernel")
                 + ptxas_report("flash_attention_kernel")
                 + ptxas_report("paged_attention_split_kernel", "Li4E")
                 + ptxas_report("paged_attention_combine_kernel")
                 + ptxas_report("rwkv6_scan_kernel", "ILi64E")
                 + ptxas_report("rwkv6_chunk_state_kernel")
                 + ptxas_report("chunk_pass_kernel")
                 + ptxas_report("rwkv6_chunk_out_kernel")
                 + ptxas_report("ssd_scan_kernel", "ILi64ELi64E")
                 + ptxas_report("ssd_seg_state_kernel")
                 + ptxas_report("ssd_seg_out_kernel")
                 + ptxas_report("rmsnorm_bwd")
                 + ptxas_report("fa_bwd", "Li64E")
                 + ptxas_report("fa_bwd", "Li128E")
                 + ptxas_report("fa_bwd", "Li256E")
                 + ptxas_report("rwkv6_scan_bwd_kernel", "ILi64E")
                 + ptxas_report("ssd_scan_bwd_kernel", "ILi64E")
                 + ptxas_report("rwkv6_chunk_bwd_kernel")
                 + ptxas_report("ssd_bwd_chunk_state_kernel")
                 + ptxas_report("ssd_chunk_bwd_kernel")):
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
    train_errs, offset_launches = phase_parity_train(dev)
    errs["flash_attention"] = max(errs["flash_attention"],
                                  train_errs.pop("flash_attention"))
    errs.update(train_errs)
    for name, e in phase_parity_train_recurrent(dev).items():
        errs[name] = max(errs.get(name, 0.0), e)
    phase_small(dev)
    phase_small_rwkv(dev)
    phase_small_zamba(dev)
    phase_small_train(dev)
    main_base = torch.cuda.memory_allocated()
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
    traffic = phase_traffic(main_rate)
    # disaggregated prefill/decode: qwen2-7b (bf16 and int8 pages, serial
    # and thread), qwen2.5-14b beside its monolithic run, open-loop traffic
    t_disagg = time.perf_counter()
    disagg = phase_main_disagg(bf16_peak - main_base, ref_streams,
                               int8_streams)
    times["paged_attention_mq"].update(
        phase_timing_heads(dev, get_config("qwen2.5-14b"), "g5", 5))
    mesh_s = phase_main_14b()
    traffic_disagg = phase_traffic(main_rate, ["--disagg"], "traffic-disagg")
    log("traffic-disagg beside traffic: " + "; ".join(
        f"{m} p50 {traffic_disagg[m]['p50']:.4f} s (monolithic "
        f"{traffic[m]['p50']:.4f} s) p99 {traffic_disagg[m]['p99']:.4f} s "
        f"(monolithic {traffic[m]['p99']:.4f} s)" for m in ("ttft", "itl"))
        + f"; {traffic_disagg['tok_per_s']:.2f} tok/s (monolithic "
        f"{traffic['tok_per_s']:.2f}); first to second token p50 "
        f"{np.percentile(traffic_disagg['second_token_gaps'], 50):.4f} s "
        f"(monolithic {np.percentile(traffic['second_token_gaps'], 50):.4f}"
        f" s); the three disaggregated phases took "
        f"{time.perf_counter() - t_disagg:.1f} s")
    # the serial MoE path (ROADMAP A9a): B1 at qwen3-moe's G 16, then
    # full-width qwen3-moe and arctic, each after every earlier phase's
    # tensors are freed (init_model empties the cache first)
    gc.collect()
    torch.cuda.empty_cache()
    times["paged_attention_mq"].update(
        phase_timing_heads(dev, get_config(MOE_ARCH), "g16", 16))
    t_moe = time.perf_counter()
    moe = {"main-moe": phase_main_moe()}
    moe["main-moe-placed"] = phase_main_moe_placed()
    moe["main-arctic"] = phase_main_arctic()
    phase_moe_block(dev)
    log(f"the four MoE phases took {time.perf_counter() - t_moe:.1f} s")
    # tensor parallelism's per-rank heads: B1 at the shard shapes
    t_heads = time.perf_counter()
    times["paged_attention_mq"]["shard_heads"] = phase_shard_heads(dev)
    mesh_s += (moe["main-moe"]["mesh_s"] + moe["main-moe-placed"]["mesh_s"]
               + time.perf_counter() - t_heads)
    log(f"the serving-mesh phases (main-mesh, main-moe-mesh, "
        f"main-moe-placed-mesh, B1 at the shard shapes) added {mesh_s:.1f} s")
    # multimodal serving (ROADMAP A10): B1 and B3 at its shapes, then
    # full-width llava and whisper through the launcher
    gc.collect()
    torch.cuda.empty_cache()
    t_mm = time.perf_counter()
    mm_times = phase_timing_mm(dev)
    mm = {"main-vlm": phase_main_vlm()}
    mm["main-whisper"] = phase_main_whisper()
    log(f"the multimodal phases (timing, main-vlm, main-whisper) took "
        f"{time.perf_counter() - t_mm:.1f} s")
    for name in ("paged_attention_mq", "flash_attention"):
        times[name]["multimodal"] = {
            "timed": mm_times[name],
            "launches": {run: r["launches"][name] for run, r in mm.items()
                         if name in r["launches"]}}
    times["rmsnorm"]["multimodal"] = {
        "launches": {"main-vlm": mm["main-vlm"]["launches"]["rmsnorm"]}}
    # the paper's function-centric layer: no TPU kernel on this path
    gc.collect()
    torch.cuda.empty_cache()
    phase_science_runtime(dev)
    phase_science_mcmc(dev)
    phase_science_dmc(dev)
    phase_science_boussinesq(dev)
    # one-card training (ROADMAP A13a) and gemma3's window caches (A11)
    gc.collect()
    torch.cuda.empty_cache()
    t_new = time.perf_counter()
    train = phase_main_train(dev)
    # rwkv6 and zamba2 training on one card (ROADMAP A13b item 4)
    t_rec = time.perf_counter()
    train_rwkv = phase_main_train_recurrent(
        dev, "main-train-rwkv", get_config(TRAIN_RWKV_ARCH), False)
    train_zamba = phase_main_train_recurrent(
        dev, "main-train-zamba", get_config(TRAIN_ZAMBA_ARCH).replace(
            n_layers=TRAIN_ZAMBA_LAYERS), True)
    t_rec = time.perf_counter() - t_rec
    t_mesh = time.perf_counter()
    train_mesh = phase_main_train_mesh(train)
    t_mesh = time.perf_counter() - t_mesh
    # MoE training and remat="dots" (ROADMAP A13b items 3 and 6)
    t_moe = time.perf_counter()
    phase_main_train_dots(dev, train)
    train_moe = phase_main_train_moe(dev)
    t_moe = time.perf_counter() - t_moe
    gemma = phase_main_gemma3(dev)
    train_times = phase_timing_train(dev, smi)
    t_rec_timing = time.perf_counter()
    rec_times = phase_timing_train_recurrent(dev, smi)
    t_rec += time.perf_counter() - t_rec_timing
    log(f"the training and gemma3 phases (main-train, main-train-rwkv and "
        f"main-train-zamba with their timing rows ({t_rec:.1f} s), "
        f"main-train-mesh and pod-dp ({t_mesh:.1f} s), main-train-dots and "
        f"main-train-moe ({t_moe:.1f} s), main-gemma3, timing-train) took "
        f"{time.perf_counter() - t_new:.1f} s")
    # parity at the shapes the phases served and trained at
    for name in ("rwkv6_scan_bwd", "ssd_scan_bwd"):
        errs[name] = max(errs[name], rec_times[name].pop("max_abs_err"))
    for r in (*mm.values(), train, train_moe, gemma, train_zamba):
        for name, e in r["errs"].items():
            errs[name] = max(errs.get(name, 0.0), e)
    times["flash_attention"]["gemma3"] = {
        "timed": train_times["flash_attention"],
        "launches": gemma["launches"], "steps": gemma["steps"]}
    times["flash_attention"]["train_launches"] = {
        k: train["launches"][k] for k in ("flash_attention",
                                          "flash_attention_tc")}
    times["flash_attention"]["offset"] = {
        "timed": train_times["flash_attention"]["sp_block"],
        "backward_timed": train_times["flash_attention_bwd"]["sp_block"],
        "parity_launches": offset_launches}
    mesh_launches = train_mesh["launches"]
    times["flash_attention"]["train_mesh_launches"] = {
        k: mesh_launches[k] for k in ("flash_attention",
                                      "flash_attention_tc")}
    times["rmsnorm"]["train_mesh_launches"] = {
        k: mesh_launches[k] for k in ("rmsnorm", "rmsnorm_add")}
    times["rmsnorm"]["train_launches"] = {
        k: train["launches"][k] for k in ("rmsnorm", "rmsnorm_add")}
    # main-train-moe's launches (its 10 steps), beside main-train's
    for name, keys in (("flash_attention", ("flash_attention",
                                            "flash_attention_tc")),
                       ("rmsnorm", ("rmsnorm", "rmsnorm_add"))):
        times[name]["train_moe_launches"] = {
            k: train_moe["launches"][k] for k in keys}
    for name, head in (("rmsnorm_bwd", "add_ln"),
                       ("flash_attention_bwd", "train")):
        times[name] = {**train_times[name][head],
                       "variants": train_times[name],
                       "train_mesh_launches": mesh_launches[name],
                       "train_moe_launches": train_moe["launches"][name]}
        launches[name] = train["launches"][name]
    launches["flash_attention_bwd_tc"] = train["launches"][
        "flash_attention_bwd_tc"]
    # the recurrent families' backward kernels: main-train-rwkv's and
    # main-train-zamba's launches; B3 at zamba2's head dim 112 and the
    # scans' forward launches in training beside them
    for name, run in (("rwkv6_scan_bwd", train_rwkv),
                      ("ssd_scan_bwd", train_zamba),
                      ("rmsnorm_gated_bwd", train_zamba)):
        times[name] = {**rec_times[name],
                       "train_step_ms": run["host_ms"],
                       "train_device_ms": run["device_ms"]}
        launches[name] = run["launches"][name]
        if f"{name}_tc" in run["launches"]:
            launches[f"{name}_tc"] = run["launches"][f"{name}_tc"]
    for name, run in (("rwkv6_scan", train_rwkv), ("ssd_scan", train_zamba)):
        times[name]["train_launches"] = {
            k: run["launches"][k] for k in (name, f"{name}_tc")}
    times["flash_attention"]["zamba_d112"] = {
        "timed": rec_times["flash_attention_z"],
        "launches": {k: train_zamba["launches"][k] for k in (
            "flash_attention", "flash_attention_tc")}}
    times["flash_attention_bwd"]["zamba_d112"] = {
        "timed": train_times["flash_attention_bwd"]["train_zamba"],
        "launches": {k: train_zamba["launches"][k] for k in (
            "flash_attention_bwd", "flash_attention_bwd_tc")}}
    times["rmsnorm_bwd"]["train_zamba_launches"] = {
        k: train_zamba["launches"][k] for k in (
            "rmsnorm_bwd", "rmsnorm_add_bwd", "rmsnorm_gated_bwd")}
    times["rmsnorm_bwd"]["add_launches"] = train["launches"]["rmsnorm_add_bwd"]
    times["paged_attention_mq"]["verify_launches"] = {
        f"W{W}": n for W, n in widths.items()}
    times["paged_attention_mq_int8"]["verify_launches"] = {
        f"W{W}": n for W, n in int8_widths.items()}
    times["flash_attention"]["drafter_launches"] = \
        spec_launches["flash_attention"]
    # B1's and B2's launches by role in main-disagg's serial run
    for name in ("paged_attention_mq", "rmsnorm"):
        times[name]["disagg_launches"] = {
            role: n[name] for role, n in disagg["serial"]["roles"].items()}
    # B1's, B2's and B3's launches in the MoE runs: main-moe's and
    # main-arctic's monolithic runs, main-moe-placed's dense-path run
    moe_counts = {"main-moe": moe["main-moe"]["counts"],
                  "main-arctic": moe["main-arctic"]["counts"],
                  "main-moe-placed dense": moe["main-moe-placed"][
                      "dense_counts"]}
    for name in ("paged_attention_mq", "flash_attention"):
        times[name]["moe_launches"] = {run: c[name][0]
                                       for run, c in moe_counts.items()}
    times["rmsnorm"]["moe_launches"] = {
        run: {"rmsnorm": c["rmsnorm"][0] - c["rmsnorm_add"][0],
              "add_rmsnorm": c["rmsnorm_add"][0]}
        for run, c in moe_counts.items()}
    # each kernel's launches from the run of the path that carries it
    launches["flash_attention"] = dense_launches["flash_attention"]
    launches["flash_attention_tc"] = dense_launches["flash_attention_tc"]
    times["flash_attention"].update(
        {f"s2048_{k}": times["flash_attention S=2048"][k]
         for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                   "with_lse_ms")})
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
            **({"device_kernels": DEVICE_KERNELS[name]}
               if name in DEVICE_KERNELS else {}),
            # the tensor-core route sub-counts of the scans and of B3's
            # forward and backward
            **({"tc_launches": launches[f"{name}_tc"]}
               if f"{name}_tc" in launches else {}),
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
                "launches_by_run", "disagg_launches", "g5_decode_ms",
                "g5_decode_plain_ms", "g5_decode_library_ms",
                "g5_decode_bound_ms", "g5_decode_bound_by", "g5_chunk_ms",
                "g5_chunk_plain_ms", "g5_chunk_library_ms",
                "g5_chunk_bound_ms", "g5_chunk_bound_by", "g16_decode_ms",
                "g16_decode_plain_ms", "g16_decode_library_ms",
                "g16_decode_bound_ms", "g16_decode_bound_by", "g16_chunk_ms",
                "g16_chunk_plain_ms", "g16_chunk_library_ms",
                "g16_chunk_bound_ms", "g16_chunk_bound_by",
                "moe_launches", "shard_heads", "multimodal", "gemma3",
                "train_launches", "add_launches", "library_causal_ms",
                "offset", "train_mesh_launches", "train_moe_launches",
                "cores", "with_lse_ms", "s2048_with_lse_ms", "zamba_d112",
                "train_zamba_launches", "train_step_ms", "train_device_ms",
                "plain_shape", "card", "cuda_core_ms") if k in t}})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
