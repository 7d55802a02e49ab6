"""Continuous-batching serving engine: over a paged KV cache, or over a
dense per-slot decode state (a KV cache, or rwkv6's recurrent state), on
one device or on the ranks of a serving mesh.

Counterpart of ``repro.serve.engine``:
``submit()`` requests, ``tick()`` the loop, collect
:attr:`ServeEngine.finished`.  The policy lives in
:mod:`repro_torch.serve.scheduler` (a copy of the reference's); this module
runs the scheduler's plan on the device.

* **paged** (the default): admission with a radix prefix match ->
  page-aligned chunked prefill -> copy-on-write -> one batched decode step
  for every live slot (or, with a drafter, one batched verify window) ->
  sample and commit -> retire.  ``kv_quant="int8"``
  stores the pages as int8 with per-(row, head) scale leaves;
  ``weight_quant="int8"`` keeps the weights as per-tensor int8, dequantized
  where each is used (:mod:`repro_torch.serve.quant`).
* **dense per-slot** (``paged=False``, and the only path of a family
  without a paged KV cache, such as rwkv6, which picks it by itself):
  admission -> one whole-prompt prefill per admitted request, right-padded
  to a length bucket and farmed over the paper's thread farm
  (:class:`repro_torch.core.runtime.ThreadFarmExecutor`; each task
  launches its kernels from its worker thread) ->
  :func:`repro_torch.serve.pages.write_slot` splices each prefilled state
  into its slot -> one batched decode step over every slot's state ->
  sample and commit -> retire.  The prefix cache is off, as in the
  reference.

Sampling is the reference's: greedy unless an engine-wide ``sampler`` or a
request's own ``sampler`` says otherwise, each a function ``(key, logits)
-> token`` over :mod:`repro_torch.serve.prng` keys.  A request with a
``seed`` samples its token ``i`` with ``fold_in(PRNGKey(seed), i)``; every
other draw takes a key split off the engine's, which starts at
``PRNGKey(0)`` and is split at the points the reference splits it (every
decode tick, every paged first token without a seed, every dense prefill,
every sampled verify tick), so the port's draws are the reference's.

Speculative decode (``spec_decode="ngram[-N]"`` or ``"self[-K]"``, or a
drafter object; paged path only, the dense path decodes token by token):
each tick the drafter proposes up to ``spec_k`` tokens a live slot, the
scheduler grants their write pages best-effort (never preempting), one
batched verify forward (:meth:`repro_torch.models.api.DecoderLM.
paged_verify`, paged attention over the whole (B, C) window) scores every
window, and each slot emits its accepted drafts plus one correction or
bonus token (greedy acceptance, or rejection sampling at
``spec_temperature > 0``), then hands back the pages its rejected drafts
held.  ``stats["verify_widths"]`` counts the verify ticks by window width
C (a verify forward's paged-attention calls are (B, C) windows).

The reference donates the storage to each jitted call and, when a call
raises, checks whether the donated buffers were consumed.  Here every call
writes the pool's storage in place, so a raise can leave some writes done.
The contract stays the same, by two routes:

* a failing **prefill chunk** writes only into the pages of that chunk,
  which its request holds alone and which are not registered in the prefix
  index until the chunk commits (or into the trash page, for a replayed
  chunk); releasing the request returns them to the free list, so the
  partial writes are harmless and the other residents keep their caches;
* a failing **decode tick** may have run copy-on-write copies and written
  into every live slot's pages, so the engine evicts every resident
  (recompute style: each resumes from prompt plus generated tokens and its
  greedy stream is unchanged), rebuilds zeroed storage with
  :meth:`repro_torch.serve.pages.PagePool.reset_storage`, then raises.

The dense path keeps the same contract: a failing **prefill** raised
before its state reached the engine's, so only its request is retired
(with ``error``); a failing **decode** may have written into every slot's
state, so the engine evicts every resident, rebuilds a zeroed state and
raises.

An MoE model (qwen3-moe, arctic) serves on both paths.  On the paged one
every prefill chunk, decode and verify forward returns its per-expert
telemetry, which the engine sums into ``stats`` (``moe_tokens_routed``,
``moe_dropped_tokens``, ``expert_tokens``, ``expert_imbalance``), and
``placement_interval=N`` re-places the experts every N ticks from the
tokens measured since the last placement
(:mod:`repro_torch.serve.placement`): the expert stacks are permuted from
the pristine tree and the (3, E) dispatch map is passed to every paged
call, so the streams do not change.

Tensor and expert parallelism (``mesh=``, a
:class:`repro_torch.core.comm.Mesh` from ``make_mesh``): every rank of the
mesh runs this engine as the same SPMD body (``run_ranks``), with the same
requests.  The scheduler, the page tables and the sampling stay on the
host and replicated; every rank computes the same logits and so samples
the same tokens.  A family with a paged KV cache runs Megatron TP over the
``"model"`` axis: each rank cuts its shard of every weight from the
family's ``serve_param_specs`` (int8 weights quantized whole first,
``quantize_param_specs``) and holds its ``Hkv / tp`` heads of every page;
the paged calls take the axis's Comm and all-reduce after each projection
back to d_model.  A ``("expert", "model")`` mesh also partitions whole
experts over ``"expert"`` (all-to-all dispatch), and a re-placement builds
each rank's placed shard from the pristine shards through the mesh, one
layer's stack gathered at a time.  A family without one (rwkv6, and
``paged=False``) runs slot-parallel: the params replicated, each rank
decoding its ``max_slots / tp`` slots' state and the logits all-gathered
over slots; the whole-prompt prefills run on every rank and only the slot's
owner keeps the state.  ``mesh=None`` is the single-device engine.

Disaggregated serving (:mod:`repro_torch.serve.disagg`) pairs a
``prefill_only=True`` engine, which hands each completed prefill's pages
off as a :class:`repro_torch.serve.pages.KVHandoff` instead of decoding,
with a plain engine that takes them in through :meth:`ServeEngine.
inject_prefilled`.

Encoder-attached requests (``submit(encoder_input=...)``, paged only):

* a **VLM** (llava) request carries ``(n_image_tokens, d_model)`` image
  embeddings.  They ride as a prefix of strictly negative pseudo-tokens
  (:func:`encoder_prefix_tokens`, a content hash of the embeddings), so
  the prefix cache shares a repeated image's pages as it shares text; the
  prefill chunks that cover the prefix take their rows from the
  embeddings.
* an **enc-dec** (whisper) request carries ``(n_frames, d_model)`` audio
  frames; every request of such a model must.  Each clip is encoded in
  streaming chunks on the prefill farm (encoder and cross K/V, pure
  compute), the cross K/V scattered serially into a read-only
  :class:`repro_torch.serve.pages.CrossKVPool` sized for every slot before
  any decoder chunk of the same tick reads them; the decoder's chunks,
  decode steps and verify windows read them through a ``cross`` bundle
  (dead slots at ``frames_len = 0``).  The prefix cache is off for such a
  model (the decoder's K/V depend on the audio), and it has no dense path
  and no prefill-only role, as in the reference.

A model whose ``engine_refusal()`` names a reason is refused: the hybrid
family (zamba2) serves only as an aligned batch
(:class:`repro_torch.models.api.HybridLM`), as in the reference.
"""

from __future__ import annotations

__all__ = ["Request", "ServeEngine", "encoder_prefix_tokens"]

import dataclasses
import functools
import itertools
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.runtime import ThreadFarmExecutor
from repro_torch.kernels.build import KernelError
from repro_torch.models.module import (resolve_device, shard_params,
                                       tree_leaves)
from repro_torch.serve import pages as PG
from repro_torch.serve import placement as PL
from repro_torch.serve import prng
from repro_torch.serve import quant as QZ
from repro_torch.serve import spec as SP
from repro_torch.serve.pages import PagePool
from repro_torch.serve.sampling import (greedy, spec_rejection_sample,
                                        spec_verify_greedy)
from repro_torch.serve.scheduler import (FREE, EncodeJob, Scheduler,
                                         prefill_tokens)


@dataclasses.dataclass
class Request:
    """One generation request and the engine's record of its progress."""
    rid: int
    prompt: np.ndarray                     # (prompt_len,) int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    sampler: Optional[Callable] = None     # per-request (key, logits) -> tok
    seed: Optional[int] = None             # token i is sampled with
    #                                        fold_in(PRNGKey(seed), i)
    encoder_input: Optional[np.ndarray] = None
    #                                        (n_image_tokens, d_model) image
    #                                        embeddings for a VLM, (n_frames,
    #                                        d_model) audio frames for enc-dec
    # filled by the engine:
    encoder_tokens: Optional[np.ndarray] = None
    #                                        VLM only: the image's negative
    #                                        pseudo-tokens
    #                                        (encoder_prefix_tokens)
    output: list = dataclasses.field(default_factory=list)
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None
    error: Optional[BaseException] = None  # set if prefill failed


def _bucket(n: int, buckets=(32, 64, 128, 256, 512, 1024, 2048, 4096)) -> int:
    """The padded length a whole-prompt prefill of ``n`` tokens runs at."""
    for b in buckets:
        if n <= b:
            return b
    return ((n + 4095) // 4096) * 4096


def _as_int(tok) -> int:
    """A sampler's one token (a 0-d or 1-element tensor, array or int)."""
    return int(tok.item()) if isinstance(tok, torch.Tensor) else int(tok)


def _host_tokens(toks) -> np.ndarray:
    """A sampler's batch of tokens as a writable host int array."""
    if isinstance(toks, torch.Tensor):
        toks = toks.cpu().numpy()
    return np.array(toks)


def encoder_prefix_tokens(enc: np.ndarray) -> np.ndarray:
    """Deterministic strictly negative pseudo-tokens for an image prefix,
    bit for bit the reference's.

    The prefix cache keys pages on token bytes, so an image prefix needs a
    token sequence that never collides with a real token (every real one
    is >= 0) and is a pure content hash of the embeddings: blake2b of the
    float32 bytes seeds numpy's ``default_rng``, which draws one token a
    row.  The same image maps to the same pseudo-tokens and shares pages;
    distinct images collide with probability ~2**-128."""
    import hashlib
    enc = np.ascontiguousarray(np.asarray(enc, np.float32))
    digest = hashlib.blake2b(enc.tobytes(), digest_size=16).digest()
    rng = np.random.default_rng(int.from_bytes(digest, "little"))
    draw = rng.integers(0, 2**31 - 1, size=len(enc), dtype=np.int64)
    return (-1 - draw).astype(np.int32)


class ServeEngine:
    """Continuous-batching engine on one device (``cuda`` unless ``device``
    names another): paged unless ``paged=False``; see the module
    docstring.  ``paged=None`` picks the paged path for a family with a
    paged KV cache and the dense one otherwise.  ``prefill_workers`` sizes
    the prefill farm: the dense path's whole-prompt prefills, an enc-dec
    model's encode chunks (any other paged engine has none).
    ``kv_quant`` / ``weight_quant``: "int8" or "off" (paged only).
    ``chunks_per_tick`` caps the paged path's prefill chunks a tick.
    ``strict=True`` makes a tick raise ``RuntimeError`` after it retired
    its failed requests (each with ``.error``) and committed its healthy
    work, as the reference does.  ``sampler``: the engine-wide ``(key,
    logits (B, V)) -> (B,)`` draw (greedy when None).  ``spec_decode``,
    ``spec_k``, ``spec_temperature``: speculative decode (module
    docstring).  ``prefill_only=True`` makes the engine the prefill role of
    disaggregated serving (paged only): each surviving request leaves as a
    :class:`repro_torch.serve.pages.KVHandoff` in :attr:`handoffs`.
    ``placement_interval=N`` re-places a paged MoE model's experts every N
    ticks (0: never; module docstring).  ``mesh``: a serving mesh with a
    ``"model"`` axis (and optionally ``"expert"``) over which this rank
    serves its shard; every rank of it builds the engine from the same
    whole ``params`` (module docstring)."""

    def __init__(self, model, params, *, max_slots: int = 8,
                 max_len: int = 512, page_size: int = 16,
                 num_pages: Optional[int] = None, prefill_chunk: int = 64,
                 chunks_per_tick: int = 2, prefix_cache: bool = True,
                 strict: bool = False, device=None,
                 sampler: Optional[Callable] = None,
                 prefill_workers: int = 4, paged: Optional[bool] = None,
                 spec_decode=None, spec_k: int = 4,
                 spec_temperature: float = 0.0, kv_quant=None,
                 weight_quant=None, mesh=None, prefill_only: bool = False,
                 placement_interval: int = 0):
        why = model.engine_refusal()
        if why:
            raise ValueError(f"{model.cfg.name} ({model.cfg.family}) is not "
                             f"served by the engine: the family is {why}; "
                             f"call {type(model).__name__}.prefill and "
                             "decode_step")
        self.paged = model.supports_paged_decode() if paged is None \
            else bool(paged)
        if self.paged and not model.supports_paged_decode():
            raise ValueError(
                f"{model.cfg.name} ({model.cfg.family}) has no paged KV "
                "cache; construct with paged=False")
        self.prefix_cache = bool(prefix_cache) and self.paged
        # encoder-attached serving: an enc-dec model serves paged only (the
        # dense path has nowhere to hold the cross K/V), with the prefix
        # cache off (its decoder K/V depend on the audio, so token-keyed
        # sharing would alias different clips)
        enc_dec = bool(getattr(model.cfg, "is_encoder_decoder", False))
        if not self.paged and enc_dec:
            raise ValueError(
                f"{model.cfg.name} ({model.cfg.family}) is encoder-decoder "
                "and serves through the paged engine only (cross-KV pages); "
                "drop paged=False")
        self._enc_dec = self.paged and enc_dec
        if self._enc_dec:
            self.prefix_cache = False
        self._n_image = int(model.cfg.n_image_tokens or 0) \
            if self.paged and model.cfg.family == "vlm" else 0
        if self._enc_dec or self._n_image:
            model.validate_serve_encoder(page_size=page_size,
                                         max_len=max_len,
                                         prefix_cache=self.prefix_cache)
        self.cross_pool = None
        speculate = spec_decode not in (None, "off", False)
        if speculate and self.paged and sampler is not None:
            raise ValueError(
                "spec_decode supports the default greedy sampler "
                "(spec_temperature=0, bit-identical streams) or "
                "built-in temperature rejection sampling "
                "(spec_temperature > 0); a custom engine-wide sampler "
                "cannot be verified and would be silently ignored — "
                "drop it (per-request samplers remain supported)")
        # A prefill-only engine is the producer half of disaggregated
        # serving (repro_torch.serve.disagg): it admits and chunk-prefills
        # as usual, but packages each completed prefill's pages as a
        # KVHandoff for a decoder to inject instead of decoding.  Handoff
        # moves whole refcounted pages, so it exists in paged mode only,
        # and speculation is meaningless on an engine that never decodes.
        self.prefill_only = bool(prefill_only)
        self.handoffs: list[PG.KVHandoff] = []
        if self.prefill_only and not self.paged:
            raise ValueError(
                f"prefill_only requires the paged KV engine: "
                f"{model.cfg.name} ({model.cfg.family}) has no pages to "
                "hand off; drop the flag or use a paged family")
        if self.prefill_only and speculate:
            raise ValueError(
                "spec_decode on a prefill_only engine would never run "
                "(speculation happens at decode); configure the drafter on "
                "the decoder side")
        if self.prefill_only and self._enc_dec:
            raise ValueError(
                f"prefill_only on {model.cfg.name} (enc-dec) has no cross-KV "
                "handoff: the decoder half could never read the audio pages; "
                "serve enc-dec monolithic")
        # int8 KV pages live in the pool, as scale leaves beside the pages;
        # int8 weights are wired through the paged calls only
        self.kv_quant = QZ.make_kv_quant(kv_quant)
        if self.kv_quant is not None and not self.paged:
            raise ValueError(
                f"kv_quant={getattr(self.kv_quant, 'name', kv_quant)!r} "
                f"requires the paged KV engine: {model.cfg.name} "
                f"({model.cfg.family}) "
                + ("was constructed with paged=False"
                   if model.supports_paged_decode() else
                   "has no paged KV cache to quantize")
                + "; drop the flag or use a paged family")
        if weight_quant in (None, "off", False):
            self.weight_quant = None
        elif weight_quant == "int8":
            if not self.paged:
                raise ValueError(
                    "weight_quant='int8' is wired through the paged serving "
                    f"path only: {model.cfg.name} ({model.cfg.family}) "
                    + ("was constructed with paged=False"
                       if model.supports_paged_decode() else
                       "has no paged KV cache")
                    + "; drop the flag or use a paged family")
            if isinstance(spec_decode, str) \
                    and spec_decode.partition("-")[0] == "self":
                raise ValueError(
                    "weight_quant='int8' cannot build the self-K drafter "
                    "(it slices raw float param leaves); use the ngram "
                    "drafter or pass a pre-built drafter object")
            self.weight_quant = "int8"
        else:
            raise ValueError(
                f"unknown weight_quant {weight_quant!r}; want 'int8' or "
                "'off'")
        self.device = resolve_device(device)
        for leaf in tree_leaves(params):
            if leaf.device.type != self.device.type:
                raise ValueError(f"params lie on {leaf.device}, the engine "
                                 f"runs on {self.device}")
        # the model calls get the KV policy only when one is on, so an
        # engine without it makes the calls it always made
        self._paged_kw = {} if self.kv_quant is None \
            else {"quant": self.kv_quant}
        if self.weight_quant:       # a tree quantized at init stays as it is
            params = QZ.quantize_params(params)
        # -- serving mesh: tensor-, expert- or slot-parallel -------------------
        self.mesh = mesh
        self.tp = self.ep = 1
        self._comm = self._ep_comm = None
        if mesh is not None:
            if "model" not in mesh.axis_names:
                raise ValueError(
                    f"serving mesh needs a 'model' axis, got {mesh.axis_names}")
            self.tp = int(mesh.shape["model"])
            self.ep = int(mesh.shape.get("expert", 1))
            self._comm = mesh.comm("model")
            if self.paged:
                # head-sharded TP (+ expert-partitioned EP): the family's
                # specs; the whole tree was quantized first, so each int8
                # shard keeps its weight's one scale
                model.validate_serve_mesh(tp=self.tp, ep=self.ep)
                pspecs = model.serve_param_specs(ep=self.ep)
                if self.weight_quant:
                    pspecs = QZ.quantize_param_specs(pspecs, params)
                params = shard_params(params, pspecs, mesh)
                if "expert" in mesh.axis_names:
                    self._ep_comm = mesh.comm("expert")
                self._paged_kw.update(comm=self._comm, ep_comm=self._ep_comm)
            else:
                if self.ep > 1:
                    raise ValueError(
                        f"expert-parallel serving needs the paged MoE path: "
                        f"{model.cfg.name} ({model.cfg.family}) is serving "
                        "non-paged (slot-parallel); drop the expert axis")
                if max_slots % self.tp:
                    raise ValueError(
                        f"slot-parallel serving shards slots over the mesh: "
                        f"max_slots={max_slots} must divide by tp={self.tp}")
        # the rank's own slots of the dense path's state (all of them on
        # one device)
        n_local = max_slots // self.tp
        lo = (mesh.coords["model"] if mesh is not None else 0) * n_local
        self._slots = range(lo, lo + n_local)
        self._head_kw = {"comm": self._comm} if self.paged and mesh else {}
        self.model, self.params = model, params
        self.max_slots, self.max_len = max_slots, max_len
        self.strict = strict
        if self.paged:
            if num_pages is None:       # dense-equivalent budget by default
                num_pages = -(-max_slots * max_len // page_size)
            # under a mesh the pool holds the rank's Hkv / tp heads
            leaf_specs = model.paged_leaf_specs(self.kv_quant)
            self.pool = PagePool(leaf_specs if mesh is None
                                 else PG.local_leaf_specs(leaf_specs, self.tp),
                                 num_pages=num_pages, page_size=page_size,
                                 device=self.device,
                                 prefix_cache=self.prefix_cache)
            cross_kw = {}
            if self._enc_dec:
                # one read-only cross-KV pool sized for every slot holding
                # a full-length clip (a request takes ceil(n_frames /
                # page_size) pages); the encode chunks run on the farm
                F = int(model.cfg.n_audio_frames)
                self.cross_pool = PG.CrossKVPool(
                    model.cross_leaf_specs(self.kv_quant),
                    num_pages=max_slots * -(-F // page_size),
                    page_size=page_size, device=self.device)
                cross_kw = dict(cross_pool=self.cross_pool, max_frames=F)
                self._prefill_farm = ThreadFarmExecutor(
                    num_workers=max(1, prefill_workers))
            self.sched = Scheduler(max_slots=max_slots, max_len=max_len,
                                   pool=self.pool,
                                   prefill_chunk=prefill_chunk,
                                   chunks_per_tick=chunks_per_tick,
                                   **cross_kw)
        else:
            self.pool = None
            self.sched = Scheduler(max_slots=max_slots, max_len=max_len)
            self._fresh_state = lambda: model.init_decode_state(
                n_local, max_len, device=self.device)
            self.state = self._fresh_state()
            self._prefill_farm = ThreadFarmExecutor(
                num_workers=max(1, prefill_workers))
        vocab = model.cfg.vocab
        self.sampler = sampler or (
            lambda key, logits: greedy(logits, true_vocab=vocab))
        # speculative decode: the paged path only; the dense path falls
        # back to plain per-token decode (the drafter is never consulted)
        self.spec_k = max(1, int(spec_k))
        self.spec_temperature = float(spec_temperature)
        if not speculate or not self.paged:
            self.drafter = None
        else:
            self.drafter = spec_decode if not isinstance(spec_decode, str) \
                else SP.make_drafter(spec_decode, model=model, params=params,
                                     comm=self._comm, ep_comm=self._ep_comm)
        # load-aware expert placement (paged MoE engines): the dispatch map
        # rides every paged call as a tensor; the expert stacks are
        # permuted from the pristine tree, so plans never compose
        n_exp = model.cfg.n_experts if self.paged else 0
        self.placement = None                   # PlacementPlan once updated
        self.placement_interval = int(placement_interval)
        self._params_unplaced = self.params     # pristine expert order
        self._id_plan = PL.identity_plan(n_exp, self.ep) if n_exp else None
        self._place_arr = self._dev(self._id_plan.dispatch_arrays() if n_exp
                                    else np.zeros((3, 0), np.int32))
        if n_exp:
            self._paged_kw["placement"] = self._place_arr
        self._expert_tokens = np.zeros(n_exp, np.int64)   # lifetime
        self._expert_window = np.zeros(n_exp, np.int64)   # since re-place
        self.last_token = np.zeros(max_slots, np.int32)
        self.finished: list[Request] = []
        self._rid = itertools.count()
        self._key = prng.PRNGKey(0)
        self.stats = {"ticks": 0, "tokens": 0, "prefills": 0,
                      "chunk_prefills": 0, "preemptions": 0,
                      "prefix_hits": 0, "prefix_hit_tokens": 0,
                      "cow_copies": 0, "evictions": 0, "pages_high_water": 0,
                      "draft_proposed": 0, "draft_accepted": 0,
                      "acceptance_rate": 0.0, "verify_widths": {},
                      "kv_handoffs": 0, "kv_injections": 0,
                      "encode_chunks": 0,
                      "kv_quant": self.kv_quant.name if self.kv_quant
                      else "off",
                      "weight_quant": self.weight_quant or "off",
                      "kv_bytes_per_token": QZ.kv_bytes_per_token(
                          model.paged_leaf_specs(self.kv_quant))
                      if self.paged else 0,
                      "moe_tokens_routed": 0, "moe_dropped_tokens": 0,
                      "expert_tokens": [0] * n_exp,
                      "expert_imbalance": 0.0, "placement_updates": 0}

    def _dev(self, a) -> torch.Tensor:
        """A host array as a fresh tensor on the engine's device."""
        return torch.tensor(np.asarray(a), device=self.device)

    # -- compat views --------------------------------------------------------

    @property
    def queue(self) -> list:
        """Requests admitted-but-waiting (scheduler FIFO view)."""
        return self.sched.queue

    @property
    def slot_req(self) -> list:
        """Per-slot resident request (None for a free slot)."""
        return self.sched.slot_req

    @property
    def storage(self):
        """The paged KV storage tree (it lives on the pool, the only copy;
        every tick writes into it in place); None on the dense path."""
        return self.pool.storage if self.pool is not None else None

    # -- request lifecycle ---------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 32,
               eos_id: Optional[int] = None, sampler=None,
               seed: Optional[int] = None, encoder_input=None) -> int:
        """Enqueue one request; returns its rid.  ``sampler`` (``(key,
        logits (V,)) -> token``) and ``seed`` override the engine's draw for
        this request's tokens.

        ``encoder_input`` attaches precomputed encoder embeddings: for a
        VLM the ``(n_image_tokens, d_model)`` image embeddings (served as a
        pseudo-token prefix: :func:`encoder_prefix_tokens`); for an enc-dec
        model the ``(n_frames, d_model)`` audio frames (``1 <= n_frames <=
        n_audio_frames``), which every request of it needs.  Text-only
        families refuse it.  The reference's checks and messages."""
        prompt = np.asarray(prompt, np.int32)
        enc_tok = None
        cfg = self.model.cfg
        if encoder_input is not None:
            if not self.paged:
                raise ValueError(
                    "encoder_input requires the paged engine (the dense "
                    "path prefills token batches only)")
            encoder_input = np.asarray(encoder_input, np.float32)
            if encoder_input.ndim != 2 \
                    or encoder_input.shape[-1] != cfg.d_model:
                raise ValueError(
                    f"encoder_input must be (n, d_model={cfg.d_model}), "
                    f"got {encoder_input.shape}")
            if self._enc_dec:
                F = int(cfg.n_audio_frames)
                if not 1 <= len(encoder_input) <= F:
                    raise ValueError(
                        f"{cfg.name}: encoder_input carries "
                        f"{len(encoder_input)} audio frames; want 1..{F} "
                        "(n_audio_frames)")
            elif self._n_image:
                if len(encoder_input) != self._n_image:
                    raise ValueError(
                        f"{cfg.name}: encoder_input carries "
                        f"{len(encoder_input)} image tokens; want exactly "
                        f"n_image_tokens={self._n_image}")
                enc_tok = encoder_prefix_tokens(encoder_input)
            else:
                raise ValueError(
                    f"{cfg.name} ({cfg.family}) takes no encoder_input: "
                    "only VLM and enc-dec audio families are "
                    "encoder-attached")
        elif self._enc_dec:
            raise ValueError(
                f"{cfg.name} (enc-dec) requires encoder_input: "
                "the decoder cross-attends into the audio's cross-KV pages")
        total = len(prompt) + (0 if enc_tok is None else len(enc_tok))
        if total >= self.max_len:
            what = "prompt length" if enc_tok is None \
                else "image prefix + prompt length"
            raise ValueError(f"{what} {total} >= max_len {self.max_len}")
        req = Request(next(self._rid), prompt, max_new_tokens, eos_id,
                      sampler, seed, encoder_input=encoder_input)
        req.encoder_tokens = enc_tok
        req.submitted_at = time.perf_counter()
        self.sched.submit(req)
        return req.rid

    # -- sampling ------------------------------------------------------------

    @staticmethod
    def _seeded_key(req: Request) -> np.ndarray:
        """A seeded request's key for its NEXT token depends only on
        (seed, tokens emitted so far) — never on tick count, slot id or
        admission order, so sampled streams reproduce run to run."""
        return prng.fold_in(prng.PRNGKey(req.seed), len(req.output))

    def _sample_batch(self, logits_last, slots):
        """Sample every live slot: one batched draw with the engine default,
        overridden row-wise for requests carrying their own sampler and/or
        seed.  A per-row draw that raises is isolated — returns (tokens,
        [(slot, error), ...]); the engine's own batched sampler failing
        raises."""
        self._key, sub = prng.split(self._key)
        nxt = _host_tokens(self.sampler(sub, logits_last))
        errors = []
        for slot in slots:
            req = self.sched.slot_req[slot]
            if req is None or (req.sampler is None and req.seed is None):
                continue
            k = self._seeded_key(req) if req.seed is not None \
                else prng.fold_in(sub, slot)
            fn = req.sampler or self.sampler
            try:
                nxt[slot] = _as_int(fn(k, logits_last[slot]))
            except Exception as e:                  # noqa: BLE001
                errors.append((slot, e))
        return nxt, errors

    def _sample_one(self, req: Request, logits_row) -> int:
        if req.seed is not None:
            sub = self._seeded_key(req)
        else:
            self._key, sub = prng.split(self._key)
        fn = req.sampler or self.sampler
        return _as_int(fn(sub, logits_row))

    # -- retirement ----------------------------------------------------------

    def _retire(self, slot: int):
        req = self.sched.slot_req[slot]
        req.done_at = time.perf_counter()
        self.finished.append(req)
        self.sched.release(slot)

    def _check_retire(self, slot: int, tok: int) -> bool:
        req = self.sched.slot_req[slot]
        hit_eos = req.eos_id is not None and tok == req.eos_id
        if (hit_eos or len(req.output) >= req.max_new_tokens
                or self.sched.lengths[slot] >= self.max_len - 1):
            self._retire(slot)
            return True
        return False

    def _emit_first_token(self, slot: int, tok: int):
        """Bookkeeping for the token sampled off a completed prefill (EOS
        and budget checked at once: a request may finish here).  A
        prefill-only engine hands a surviving request off to a decoder
        instead of keeping the slot live."""
        req = self.sched.slot_req[slot]
        if req.first_token_at is None:
            req.first_token_at = time.perf_counter()
        req.output.append(tok)
        self.last_token[slot] = tok
        self.stats["tokens"] += 1
        self.stats["prefills"] += 1
        if self.prefill_only:
            # instant EOS, a one-token budget or max_len still retire here:
            # there is nothing left for a decoder to do
            if not self._check_retire(slot, tok):
                self._handoff(slot)
            return
        self._check_retire(slot, tok)

    # -- disaggregated prefill/decode: page handoff ---------------------------

    def _gather_slot_kv(self, row: np.ndarray) -> dict:
        """Gather one slot's pages into a contiguous copy per pool leaf
        (``prefix + (n * page_size,) + suffix``).  The copy is independent
        of the pool's storage, so a later storage rebuild cannot touch an
        in-flight handoff."""
        tables = self._dev(np.asarray(row, np.int32)[None])
        out = {}
        for name, st in self.pool.storage.items():
            n = len(self.pool.leaf_specs[name].prefix)
            out[name] = PG.gather_pages(st, tables, n_prefix=n).squeeze(n)
        return out

    def _handoff(self, slot: int):
        """Package a completed prefill for a decoder: gather the slot's KV,
        take one in-flight reference per source page (they may stay
        registered and be re-shared by the prefix cache meanwhile, but a
        referenced page is never evicted or reallocated), then release the
        slot: full clean pages park in the prefix index as a monolithic
        retirement's would.  The KVHandoff owns the in-flight references
        until its ``release()``."""
        req = self.sched.slot_req[slot]
        total = int(self.sched.lengths[slot])
        n_kv = -(-total // self.pool.page_size)
        pages = [int(p) for p in self.sched.table[slot, :n_kv]]
        kv = self._gather_slot_kv(self.sched.table[slot, :n_kv])
        self.pool.incref(pages)
        self.sched.release(slot)
        self.stats["kv_handoffs"] += 1
        self.handoffs.append(PG.KVHandoff(req=req, length=total, kv=kv,
                                          pages=pages, pool=self.pool))

    def inject_prefilled(self, handoff: PG.KVHandoff) -> bool:
        """Decoder half of the page handoff: bind a prefilled request into a
        LIVE slot by scattering the gathered KV into freshly allocated
        pages — no recompute.  All-or-nothing like admission: returns False
        (taking nothing) when no slot is free or the pool cannot yield
        ``(length + page_size) // page_size`` pages now; the caller retries
        after a tick drains capacity.  On success the handoff's source
        references are NOT dropped: the caller owns ``handoff.release()``
        (idempotent)."""
        if not self.paged:
            raise ValueError("page handoff requires the paged KV engine")
        req, total = handoff.req, handoff.length
        assert req.output, "handoff carries the prefill's first token"
        slot = next((s for s in range(self.max_slots)
                     if self.sched.status[s] == FREE), None)
        if slot is None:
            return False
        ps = self.pool.page_size
        pages = self.pool.alloc((total + ps) // ps)
        if pages is None:
            return False
        pg = self._dev(np.asarray(pages[:-(-total // ps)], np.int32))
        for name, st in self.pool.storage.items():
            PG.scatter_chunk(st, pg, handoff.kv[name], page_size=ps,
                             n_prefix=len(self.pool.leaf_specs[name].prefix))
        self.sched.bind_prefilled(slot, req, pages, total)
        self.last_token[slot] = req.output[-1]
        self.stats["kv_injections"] += 1
        return True

    def _retire_error(self, req: Request, err: BaseException):
        req.error = err
        req.done_at = time.perf_counter()
        self.finished.append(req)

    def _raise_or_record(self, errors) -> None:
        """Retire every errored request with ``req.error`` set; under
        ``strict=True`` then raise (the tick's healthy work is already
        committed)."""
        for req, err in errors:
            self._retire_error(req, err)
        if errors and self.strict:
            rids = [req.rid for req, _ in errors]
            raise RuntimeError(
                f"prefill failed for request(s) {rids}; each request's "
                f".error holds its exception") from errors[0][1]

    def _reject_errors(self, rejects) -> list:
        def why(r):
            if len(r.prompt) == 0:
                return "empty prompt has nothing to prefill"
            return f"prompt length {len(r.prompt)} >= max_len {self.max_len}"
        return [(r, ValueError(why(r))) for r in rejects]

    def _commit_decode(self, live, logits) -> list:
        """Sample + book one decoded token for every live slot.  Slots
        whose per-request sampler raised are retired instead (their pages
        return to the pool); returns their (req, error) pairs."""
        self.stats["ticks"] += 1
        nxt, sample_errors = self._sample_batch(logits[:, -1], live)
        bad = {slot for slot, _ in sample_errors}
        for slot in live:
            if slot in bad:
                continue
            req = self.sched.slot_req[slot]
            tok = int(nxt[slot])
            req.output.append(tok)
            self.last_token[slot] = tok
            self.sched.lengths[slot] += 1
            self.stats["tokens"] += 1
            self._check_retire(slot, tok)
        errors = []
        for slot, e in sample_errors:
            req = self.sched.slot_req[slot]
            self.sched.release(slot)
            errors.append((req, e))
        return errors

    def _evict_residents(self):
        """Preempt every resident — youngest first, so the OLDEST lands back
        at the queue head and FIFO order resumes intact."""
        resident = [s for s in range(self.max_slots)
                    if self.sched.slot_req[s] is not None]
        for slot in sorted(resident,
                           key=lambda s: -int(self.sched.admitted_at[s])):
            self.sched.preempt(slot)

    # -- the tick ------------------------------------------------------------

    def _cross_bundle(self, tables, frames_len) -> dict:
        """The ``cross`` argument of an enc-dec model's paged calls."""
        return {"cross": {"storage": self.cross_pool.storage,
                          "tables": self._dev(tables),
                          "frames_len": self._dev(frames_len)}}

    def _prefill_job(self, job) -> Optional[int]:
        """Run one prefill chunk; the first token when it was the last."""
        kw = dict(self._paged_kw)
        if job.embeds is not None:      # a VLM chunk over its image prefix
            kw["embeds"] = self._dev(job.embeds[None])
        elif self._enc_dec:
            kw.update(self._cross_bundle(
                self.sched.cross_table[job.slot],
                np.int32(self.sched.enc_total[job.slot])))
        hidden, tel = self.model.paged_prefill_chunk(
            self.params, self.pool.storage,
            self._dev(self.sched.table[job.slot]), self._dev(job.pages),
            job.start, self._dev(job.tokens[None]), **kw)
        self._account_moe(tel)
        self.sched.chunk_done(job)
        self.stats["chunk_prefills"] += 1
        if not job.is_last:
            return None
        i = job.n_valid - 1
        logits = self.model.lm_head(self.params, hidden[:, i:i + 1],
                                    **self._head_kw)
        return self._sample_one(job.req, logits[0, -1])

    def _encode(self, job):
        """One audio chunk's encoder and cross K/V (pure compute, a farm
        task): ``(k, v)`` of (Ld, Cf, h, hd), or the exception it raised."""
        try:
            return self.model.cross_kv_chunk(
                self.params, self.model.encode_chunk(
                    self.params, self._dev(job.frames[None]), job.start,
                    job.n_valid))
        except Exception as e:                          # noqa: BLE001
            return e

    def _encode_jobs(self, jobs, failed: set, errors: list) -> None:
        """Streaming chunked encode: the chunks of different requests
        overlap on the prefill farm; each result is scattered into its cross
        pages serially after, before any decoder chunk of this tick reads
        them.  A failing chunk retires its request alone."""
        results, _ = self._prefill_farm.map_callables(
            [functools.partial(self._encode, job) for job in jobs])
        for job, res in zip(jobs, results):
            if job.slot in failed \
                    or self.sched.slot_req[job.slot] is not job.req:
                continue
            try:
                if isinstance(res, Exception):
                    raise res
                self.model.scatter_cross(
                    self.cross_pool.storage, self._dev(job.pages), *res,
                    page_size=self.cross_pool.page_size,
                    quant=self.kv_quant)
                self.sched.encode_done(job)
                self.stats["encode_chunks"] += 1
            except Exception as e:                      # noqa: BLE001
                failed.add(job.slot)
                self.sched.release(job.slot)
                errors.append((job.req, e))

    def _tick_paged(self) -> bool:
        _, rejects = self.sched.admit()
        errors = self._reject_errors(rejects)

        failed = set()
        jobs = self.sched.next_chunks()
        enc_jobs = [j for j in jobs if isinstance(j, EncodeJob)]
        if enc_jobs:
            self._encode_jobs(enc_jobs, failed, errors)
        for job in jobs:
            if isinstance(job, EncodeJob):
                continue
            if job.slot in failed or self.sched.slot_req[job.slot] is not job.req:
                continue
            # error isolation: a request that dies mid-prefill hands every
            # page back (its partial writes are harmless: module docstring)
            try:
                tok = self._prefill_job(job)
            except Exception as e:                      # noqa: BLE001
                failed.add(job.slot)
                self.sched.release(job.slot)
                errors.append((job.req, e))
                continue
            if tok is not None:
                self._emit_first_token(job.slot, tok)

        live = self.sched.live_slots()
        cow = []
        drafts = {}
        if live and self.drafter is not None:
            try:
                drafts = self._propose_drafts(live)
            except Exception:
                for req, err in errors:
                    self._retire_error(req, err)
                raise
        if live:
            # may preempt the youngest and/or schedule copy-on-write moves;
            # draft windows reserve their extra write pages best-effort
            # (never preempting — speculation can't evict anyone)
            _, cow, granted = self.sched.ensure_decode_pages(
                extra={s: len(d) for s, d in drafts.items()} or None)
            drafts = {s: d[:granted.get(s, 0)]
                      for s, d in drafts.items()
                      if self.sched.slot_req[s] is not None
                      and granted.get(s, 0) > 0}
            live = self.sched.live_slots()
            # a COW'd slot preempted later in the same pass already gave
            # its copy page back — don't write into it
            cow = [(s, a, b) for s, a, b in cow
                   if self.sched.slot_req[s] is not None]
        self.stats["preemptions"] = self.sched.preemptions
        if live:
            ps = self.pool.page_size
            B = self.max_slots
            # verify width: the widest granted draft + 1, bucketed to two
            # widths (half / full window)
            C = self._spec_width(max(len(d) for d in drafts.values())
                                 + 1) if drafts else 1
            wpages = np.full((B, C), self.pool.trash_page, np.int32)
            woffs = np.zeros((B, C), np.int32)
            lens = np.zeros(B, np.int32)
            toks = np.zeros((B, C), np.int32)
            for slot in live:
                ln = int(self.sched.lengths[slot])
                lens[slot] = ln
                toks[slot, 0] = self.last_token[slot]
                d = drafts.get(slot)
                nd = 0 if d is None else len(d)
                if nd:
                    toks[slot, 1:1 + nd] = d
                for i in range(nd + 1):
                    wpages[slot, i] = self.sched.table[slot, (ln + i) // ps]
                    woffs[slot, i] = (ln + i) % ps
            # sampled speculation (spec_temperature > 0) routes EVERY tick
            # through the verify commit, so a no-draft tick never falls
            # back to the engine's greedy sampler
            verify = bool(drafts) or (self.drafter is not None
                                      and self.spec_temperature > 0)
            if verify:
                widths = self.stats["verify_widths"]
                widths[C] = widths.get(C, 0) + 1
            if not verify:          # a decode step writes one token a slot
                wpages, woffs = wpages[:, 0], woffs[:, 0]
            step = self.model.paged_verify if verify \
                else self.model.paged_decode_step
            kw = self._paged_kw
            if self._enc_dec:
                # dead slots read at frames_len 0: the whole cross read is
                # masked to zeros, so their stale table rows are never seen
                flens = np.zeros(B, np.int32)
                for slot in live:
                    flens[slot] = self.sched.enc_total[slot]
                kw = dict(kw, **self._cross_bundle(self.sched.cross_table,
                                                   flens))
            try:
                if cow:         # copies strictly before this tick's writes
                    PG.copy_pages(self.pool.storage, self.pool.leaf_specs,
                                  self._dev([a for _, a, _ in cow]),
                                  self._dev([b for _, _, b in cow]))
                logits, tel = step(self.params, self.pool.storage,
                                   self._dev(self.sched.table),
                                   self._dev(lens), self._dev(toks),
                                   self._dev(wpages), self._dev(woffs), **kw)
                self._account_moe(tel)
                errors += self._commit_verify(live, drafts, logits) \
                    if verify else self._commit_decode(live, logits)
            except BaseException:
                # engine-level failure: the in-place writes may have touched
                # every live slot, so evict and rebuild before raising, and
                # retire this tick's prefill failures with their errors
                self._evict_residents()
                self.pool.reset_storage()
                for req, err in errors:
                    self._retire_error(req, err)
                raise

        self.stats.update(
            prefix_hits=self.sched.prefix_hits,
            prefix_hit_tokens=self.sched.prefix_hit_tokens,
            cow_copies=self.sched.cow_copies,
            evictions=self.pool.evictions,
            pages_high_water=self.pool.high_water)
        proposed = self.stats["draft_proposed"]
        self.stats["acceptance_rate"] = (
            self.stats["draft_accepted"] / proposed if proposed else 0.0)
        if (self.placement_interval and self._expert_tokens.size
                and self.stats["ticks"] % self.placement_interval == 0
                and self._expert_window.sum()):
            self.update_placement()
        self._raise_or_record(errors)
        return bool(live) or self.sched.has_work()

    # -- expert telemetry + load-aware placement -----------------------------

    def _account_moe(self, tel) -> None:
        """Fold one forward's per-expert telemetry into the engine's stats
        (a dense model's is empty)."""
        if self._expert_tokens.size == 0:
            return
        t = tel["expert_tokens"].cpu().numpy().astype(np.int64)
        d = tel["expert_dropped"].cpu().numpy().astype(np.int64)
        self._expert_tokens += t
        self._expert_window += t
        self.stats["moe_tokens_routed"] += int(t.sum())
        self.stats["moe_dropped_tokens"] += int(d.sum())
        self.stats["expert_tokens"] = self._expert_tokens.tolist()
        if self._expert_window.sum():
            plan = self.placement or self._id_plan
            self.stats["expert_imbalance"] = PL.imbalance(
                plan.rank_loads(self._expert_window))

    def update_placement(self, plan=None):
        """Re-place the experts between ticks from the measured token
        window.

        ``plan=None`` computes one with
        :func:`repro_torch.serve.placement.plan_placement` (hot-expert
        replication on); an explicit :class:`PlacementPlan` is applied as
        it is.  The expert stacks are permuted from the pristine
        (identity-order) params, so plans never compose, and the dispatch
        map goes to every later paged call.  The previous placed copy is
        let go first, so at most one exists beside the pristine tree.
        Returns the active plan (None when the window was empty)."""
        if self._expert_tokens.size == 0:
            raise ValueError(
                f"{self.model.cfg.name}: expert placement needs a paged "
                "MoE model")
        if plan is None:
            if not self._expert_window.sum():
                return None
            plan = PL.plan_placement(self._expert_window, self.ep)
        self.params = self._params_unplaced
        self.params = PL.apply_placement(self._params_unplaced, plan) \
            if self.mesh is None else self._placed_shards(plan)
        self.placement = plan
        self._place_arr = self._dev(plan.dispatch_arrays())
        self._paged_kw["placement"] = self._place_arr
        self._expert_window[:] = 0
        self.stats["placement_updates"] += 1
        return plan

    def _placed_shards(self, plan):
        """This rank's shard of the placed expert stacks under a mesh: the
        experts' shard index runs expert-major over the mesh axes the
        stacks split over, so shard ``i`` holds physical slots ``[i * E_sh,
        (i + 1) * E_sh)``.  Each stack is rebuilt one layer at a time: the
        layer's pristine shards are all-gathered over the mesh (the whole
        layer's stack, on one rank of a world of one the shard itself) and
        the rank's physical slots picked out of it, so no rank holds more
        than one gathered layer beside its pristine and placed shards."""
        mesh, world = self.mesh, self.mesh.world
        axes = tuple(a for a in ("expert", "model") if a in mesh.axis_names)
        idx, n = mesh.index(axes)
        e_sh = self.model.cfg.n_experts // n
        # the world rank holding each pristine shard, and so each logical
        # expert's row in a layer gathered in world-rank order
        holder = np.argsort([mesh.index(axes, r)[0]
                             for r in range(world.size())])
        experts = np.asarray(plan.phys_expert[idx * e_sh:(idx + 1) * e_sh],
                             np.int64)
        rows = self._dev(holder[experts // e_sh] * e_sh + experts % e_sh)
        pristine = self._params_unplaced["blocks"]["moe"]
        moe = dict(pristine)
        for name in ("gate", "up", "down"):
            leaf = pristine[name]
            src = leaf["q8"] if QZ.is_q8(leaf) else leaf
            out = torch.empty_like(src)
            for layer in range(src.shape[0]):
                part = src[layer]
                full = part if world.size() == 1 else world.all_gather(
                    part, tiled=True)
                torch.index_select(full, 0, rows, out=out[layer])
                del full
            moe[name] = dict(leaf, q8=out) if QZ.is_q8(leaf) else out
        blocks = dict(self._params_unplaced["blocks"], moe=moe)
        return dict(self._params_unplaced, blocks=blocks)

    # -- speculative decode --------------------------------------------------

    def _spec_width(self, need: int) -> int:
        half = 1 + (self.spec_k + 1) // 2
        return half if need <= half else self.spec_k + 1

    def _propose_drafts(self, live) -> dict:
        """Ask the drafter for up to ``spec_k`` continuation tokens per
        spec-eligible live slot, never past the request's remaining token
        budget or into ``max_len``'s last writable position.  A drafter
        raising (or proposing nothing) means no drafts for that slot this
        tick — unless it is the port's own self-drafter, or what raised is
        a kernel (:class:`KernelError`): those propagate, since a kernel
        that fails or refuses its input must not read as "no drafts"."""
        drafts = {}
        for slot in live:
            req = self.sched.slot_req[slot]
            if req.sampler is not None:
                continue        # black-box per-request sampler: unverifiable
            budget = min(self.spec_k,
                         req.max_new_tokens - len(req.output) - 1,
                         self.max_len - 2 - int(self.sched.lengths[slot]))
            if budget <= 0:
                continue
            try:
                prop = np.asarray(self.drafter.propose(
                    prefill_tokens(req), budget), np.int32).reshape(-1)
            except Exception as e:                      # noqa: BLE001
                if isinstance(e, KernelError) or isinstance(
                        self.drafter, SP.TruncatedSelfDrafter):
                    raise
                continue        # a sloppy drafter costs nothing
            if prop.size:
                drafts[slot] = prop[:budget]
        return drafts

    def _commit_verify(self, live, drafts, logits) -> list:
        """Book a verify forward's emitted tokens for every live slot: the
        accepted draft prefix + one correction/bonus each (a slot without
        drafts emits exactly its plain decoded token), retiring at the same
        stream position as plain decode; then every surviving slot hands
        its over-reserved verify pages back to the pool.  Returns the
        (req, error) pairs of slots whose own sampler raised."""
        self.stats["ticks"] += 1
        greedy_mode = self.spec_temperature <= 0
        if greedy_mode:         # the rejection path never reads the argmax
            rows = greedy(logits, true_vocab=self.model.cfg.vocab) \
                .cpu().numpy()
        else:
            self._key, tick_key = prng.split(self._key)
            logits_np = logits.cpu().numpy()
        errors = []
        for slot in live:
            req = self.sched.slot_req[slot]
            d = drafts.get(slot)
            nd = 0 if d is None else len(d)
            draft = [] if d is None else [int(t) for t in d]
            if req.sampler is not None:
                # black-box sampler (no drafts were proposed for it): one
                # token off position 0, error-isolated like _sample_batch
                try:
                    accepted, emitted = 0, [self._sample_one(req,
                                                             logits[slot, 0])]
                except Exception as e:                  # noqa: BLE001
                    self.sched.release(slot)
                    errors.append((req, e))
                    continue
            elif not greedy_mode:
                if req.seed is not None:
                    base = prng.PRNGKey(req.seed)
                    keys = [prng.fold_in(base, len(req.output) + i)
                            for i in range(nd + 1)]
                else:
                    keys = [prng.fold_in(tick_key,
                                         slot * (self.spec_k + 2) + i)
                            for i in range(nd + 1)]
                accepted, emitted = spec_rejection_sample(
                    keys, logits_np[slot, :nd + 1], draft,
                    temperature=self.spec_temperature,
                    true_vocab=self.model.cfg.vocab)
            else:
                accepted, emitted = spec_verify_greedy(rows[slot], draft)
            self.stats["draft_proposed"] += nd
            self.stats["draft_accepted"] += accepted
            for tok in emitted:
                tok = int(tok)
                req.output.append(tok)
                self.last_token[slot] = tok
                self.sched.lengths[slot] += 1
                self.stats["tokens"] += 1
                if self._check_retire(slot, tok):
                    break
            self.sched.rollback_verify_pages(slot)
        return errors

    # -- dense tick ------------------------------------------------------------

    def _prefill_one(self, job, key):
        """One request's whole-prompt prefill and first token, drawn with
        ``key`` by the request's sampler or the engine's (a seed is not
        read here, as in the reference): a self-contained farm task (it
        writes nothing the engine holds).  Returns the prefill's (B = 1)
        decode state and the token."""
        n = job.n_valid
        bucket = min(_bucket(n), self.max_len)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :n] = job.tokens[:n]                 # right-pad into bucket
        state, hidden = self.model.prefill(self.params, self._dev(toks))
        if job.slot not in self._slots:
            state = None    # another rank of the mesh keeps this slot
        # right-padding: KV cache rows beyond n hold pad garbage, but
        # lengths[slot] = n masks them out (kv_valid_len) and later decode
        # tokens overwrite them in order.  A recurrent state (rwkv6) has no
        # such mask: the pad tokens run through the recurrence and the
        # slot's state is the padded sequence's, exactly as in the
        # reference (ROADMAP, Queue C)
        logits = self.model.lm_head(self.params, hidden[:, n - 1:n])
        fn = job.req.sampler or self.sampler
        return state, _as_int(fn(key, logits[0, -1]))

    def _tick_dense(self) -> bool:
        _, rejects = self.sched.admit()
        errors = self._reject_errors(rejects)

        jobs = self.sched.next_chunks()          # dense: whole-prompt jobs
        if jobs:
            keys = []
            for _ in jobs:                       # keys drawn in slot order
                self._key, sub = prng.split(self._key)
                keys.append(sub)

            def guarded(job, key):
                # isolate failures so one bad request cannot drop the
                # other concurrently admitted requests
                try:
                    return self._prefill_one(job, key)
                except Exception as e:                      # noqa: BLE001
                    return e

            results, _ = self._prefill_farm.map_callables(
                [functools.partial(guarded, job, key)
                 for job, key in zip(jobs, keys)])
            for job, res in zip(jobs, results):
                if isinstance(res, Exception):
                    self.sched.release(job.slot)
                    errors.append((job.req, res))
                    continue
                state, tok = res
                if state is not None:
                    PG.write_slot(self.state, state,
                                  job.slot - self._slots.start)
                self.sched.chunk_done(job)
                self._emit_first_token(job.slot, tok)

        live = self.sched.live_slots()
        if live:
            # the rank's own slots (every slot on one device)
            own = slice(self._slots.start, self._slots.stop)
            toks = self._dev(self.last_token[own].reshape(-1, 1))
            pos = self._dev(self.sched.lengths[own].astype(np.int32))
            try:
                logits = self.model.decode_step(self.params, self.state,
                                                toks, pos)
                if self.mesh is not None:   # every rank samples every slot
                    logits = self._comm.all_gather(logits, axis=0,
                                                   tiled=True)
                errors += self._commit_decode(live, logits)
            except BaseException:
                # the in-place writes may have touched every slot's state:
                # evict and rebuild before raising
                self._evict_residents()
                self.state = None              # let the old buffers go first
                self.state = self._fresh_state()
                for req, err in errors:
                    self._retire_error(req, err)
                raise

        self._raise_or_record(errors)
        return bool(live) or self.sched.has_work()

    def tick(self) -> bool:
        """One serving step; True while the engine still has work."""
        return self._tick_paged() if self.paged else self._tick_dense()

    def run_until_drained(self, max_ticks: int = 10_000):
        """Tick until idle; returns the finished requests."""
        for _ in range(max_ticks):
            busy = self.tick()
            if not busy and not self.sched.has_work():
                break
        return self.finished

    # -- lifecycle -----------------------------------------------------------

    def close(self):
        """Release the prefill farm's threads.  The engine stays usable: the
        farm makes a new pool at its next call."""
        farm = getattr(self, "_prefill_farm", None)
        if farm is not None:
            farm.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:       # interpreter teardown: best effort only
            pass
