"""Continuous-batching serving engine on one device: over a paged KV
cache, or over a dense per-slot decode state (a KV cache, or rwkv6's
recurrent state).

Counterpart of the single-device paths of ``repro.serve.engine``:
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

Features of the reference engine that later port slices bring (encoder
inputs, the device mesh, prefill-only disaggregation) raise
``NotImplementedError`` here instead of being ignored.  A model whose
``engine_refusal()`` names a reason is refused: the hybrid family (zamba2)
serves only as an aligned batch
(:class:`repro_torch.models.api.HybridLM`), as in the reference.
"""

from __future__ import annotations

__all__ = ["Request", "ServeEngine"]

import dataclasses
import functools
import itertools
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.runtime import ThreadFarmExecutor
from repro_torch.kernels.build import KernelError
from repro_torch.models.module import resolve_device, tree_leaves
from repro_torch.serve import pages as PG
from repro_torch.serve import prng
from repro_torch.serve import quant as QZ
from repro_torch.serve import spec as SP
from repro_torch.serve.pages import PagePool
from repro_torch.serve.sampling import (greedy, spec_rejection_sample,
                                        spec_verify_greedy)
from repro_torch.serve.scheduler import Scheduler, prefill_tokens


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


def _not_ported(what: str, slice_name: str):
    return NotImplementedError(
        f"{what} is not ported yet: it comes with the {slice_name} slice")


class ServeEngine:
    """Continuous-batching engine on one device (``cuda`` unless ``device``
    names another): paged unless ``paged=False``; see the module
    docstring.  ``paged=None`` picks the paged path for a family with a
    paged KV cache and the dense one otherwise.  ``prefill_workers`` sizes
    the dense path's prefill farm (a paged engine has none).
    ``kv_quant`` / ``weight_quant``: "int8" or "off" (paged only).
    ``chunks_per_tick`` caps the paged path's prefill chunks a tick.
    ``strict=True`` makes a tick raise ``RuntimeError`` after it retired
    its failed requests (each with ``.error``) and committed its healthy
    work, as the reference does.  ``sampler``: the engine-wide ``(key,
    logits (B, V)) -> (B,)`` draw (greedy when None).  ``spec_decode``,
    ``spec_k``, ``spec_temperature``: speculative decode (module
    docstring)."""

    def __init__(self, model, params, *, max_slots: int = 8,
                 max_len: int = 512, page_size: int = 16,
                 num_pages: Optional[int] = None, prefill_chunk: int = 64,
                 chunks_per_tick: int = 2, prefix_cache: bool = True,
                 strict: bool = False, device=None,
                 sampler: Optional[Callable] = None,
                 prefill_workers: int = 4, paged: Optional[bool] = None,
                 spec_decode=None, spec_k: int = 4,
                 spec_temperature: float = 0.0, kv_quant=None,
                 weight_quant=None, mesh=None, prefill_only: bool = False):
        refused = [(mesh is not None, "a device mesh", "MoE with TP/EP"),
                   (bool(prefill_only), "prefill_only",
                    "traffic, metrics and disagg")]
        for bad, what, slice_name in refused:
            if bad:
                raise _not_ported(what, slice_name)
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
        speculate = spec_decode not in (None, "off", False)
        if speculate and self.paged and sampler is not None:
            raise ValueError(
                "spec_decode supports the default greedy sampler "
                "(spec_temperature=0, bit-identical streams) or "
                "built-in temperature rejection sampling "
                "(spec_temperature > 0); a custom engine-wide sampler "
                "cannot be verified and would be silently ignored — "
                "drop it (per-request samplers remain supported)")
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
        self.model, self.params = model, params
        self.max_slots, self.max_len = max_slots, max_len
        self.strict = strict
        self.prefix_cache = bool(prefix_cache) and self.paged
        if self.paged:
            if num_pages is None:       # dense-equivalent budget by default
                num_pages = -(-max_slots * max_len // page_size)
            self.pool = PagePool(model.paged_leaf_specs(self.kv_quant),
                                 num_pages=num_pages, page_size=page_size,
                                 device=self.device,
                                 prefix_cache=self.prefix_cache)
            self.sched = Scheduler(max_slots=max_slots, max_len=max_len,
                                   pool=self.pool,
                                   prefill_chunk=prefill_chunk,
                                   chunks_per_tick=chunks_per_tick)
        else:
            self.pool = None
            self.sched = Scheduler(max_slots=max_slots, max_len=max_len)
            self._fresh_state = lambda: model.init_decode_state(
                max_slots, max_len, device=self.device)
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
                else SP.make_drafter(spec_decode, model=model, params=params)
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
                      "kv_quant": self.kv_quant.name if self.kv_quant
                      else "off",
                      "weight_quant": self.weight_quant or "off",
                      "kv_bytes_per_token": QZ.kv_bytes_per_token(
                          self.pool.leaf_specs) if self.paged else 0}

    def _dev(self, a) -> torch.Tensor:
        """A host array as a fresh tensor on the engine's device."""
        return torch.tensor(np.asarray(a), device=self.device)

    # -- request lifecycle ---------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 32,
               eos_id: Optional[int] = None, sampler=None,
               seed: Optional[int] = None, encoder_input=None) -> int:
        """Enqueue one request; returns its rid.  ``sampler`` (``(key,
        logits (V,)) -> token``) and ``seed`` override the engine's draw for
        this request's tokens."""
        if encoder_input is not None:
            raise _not_ported("encoder_input", "multimodal")
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) >= self.max_len:
            raise ValueError(
                f"prompt length {len(prompt)} >= max_len {self.max_len}")
        req = Request(next(self._rid), prompt, max_new_tokens, eos_id,
                      sampler, seed)
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
        req = self.sched.slot_req[slot]
        if req.first_token_at is None:
            req.first_token_at = time.perf_counter()
        req.output.append(tok)
        self.last_token[slot] = tok
        self.stats["tokens"] += 1
        self.stats["prefills"] += 1
        self._check_retire(slot, tok)

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

    def _prefill_job(self, job) -> Optional[int]:
        """Run one prefill chunk; the first token when it was the last."""
        hidden = self.model.paged_prefill_chunk(
            self.params, self.pool.storage,
            self._dev(self.sched.table[job.slot]), self._dev(job.pages),
            job.start, self._dev(job.tokens[None]), **self._paged_kw)
        self.sched.chunk_done(job)
        self.stats["chunk_prefills"] += 1
        if not job.is_last:
            return None
        i = job.n_valid - 1
        logits = self.model.lm_head(self.params, hidden[:, i:i + 1])
        return self._sample_one(job.req, logits[0, -1])

    def _tick_paged(self) -> bool:
        _, rejects = self.sched.admit()
        errors = self._reject_errors(rejects)

        failed = set()
        for job in self.sched.next_chunks():
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
            try:
                if cow:         # copies strictly before this tick's writes
                    PG.copy_pages(self.pool.storage, self.pool.leaf_specs,
                                  self._dev([a for _, a, _ in cow]),
                                  self._dev([b for _, _, b in cow]))
                logits = step(self.params, self.pool.storage,
                              self._dev(self.sched.table), self._dev(lens),
                              self._dev(toks), self._dev(wpages),
                              self._dev(woffs), **self._paged_kw)
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
        self._raise_or_record(errors)
        return bool(live) or self.sched.has_work()

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
                PG.write_slot(self.state, state, job.slot)
                self.sched.chunk_done(job)
                self._emit_first_token(job.slot, tok)

        live = self.sched.live_slots()
        if live:
            toks = self._dev(self.last_token.reshape(-1, 1))
            pos = self._dev(self.sched.lengths.astype(np.int32))
            try:
                logits = self.model.decode_step(self.params, self.state,
                                                toks, pos)
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
        """Release the dense path's prefill-farm threads.  The engine stays
        usable: the farm makes a new pool at its next call."""
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
