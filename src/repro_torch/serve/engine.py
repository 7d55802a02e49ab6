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
  for every live slot -> greedy commit -> retire.  ``kv_quant="int8"``
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
  greedy commit -> retire.  The prefix cache is off, as in the reference.

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

Features of the reference engine that later port slices bring (seeded and
custom sampling, encoder inputs, speculative decode, the device mesh,
prefill-only disaggregation) raise ``NotImplementedError`` here instead of
being ignored.  A model whose ``engine_refusal()`` names a reason is
refused: the hybrid family (zamba2) serves only as an aligned batch
(:class:`repro_torch.models.api.HybridLM`), as in the reference.
"""

from __future__ import annotations

__all__ = ["Request", "ServeEngine"]

import dataclasses
import functools
import itertools
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.runtime import ThreadFarmExecutor
from repro_torch.models.module import resolve_device, tree_leaves
from repro_torch.serve import pages as PG
from repro_torch.serve import quant as QZ
from repro_torch.serve.pages import PagePool
from repro_torch.serve.sampling import greedy
from repro_torch.serve.scheduler import Scheduler


@dataclasses.dataclass
class Request:
    """One generation request and the engine's record of its progress."""
    rid: int
    prompt: np.ndarray                     # (prompt_len,) int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
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
    work, as the reference does."""

    def __init__(self, model, params, *, max_slots: int = 8,
                 max_len: int = 512, page_size: int = 16,
                 num_pages: Optional[int] = None, prefill_chunk: int = 64,
                 chunks_per_tick: int = 2, prefix_cache: bool = True,
                 strict: bool = False, device=None, sampler=None,
                 prefill_workers: int = 4, paged: Optional[bool] = None,
                 spec_decode=None, kv_quant=None, weight_quant=None,
                 mesh=None, prefill_only: bool = False):
        refused = [(sampler is not None, "an engine-wide sampler",
                    "seeded sampling"),
                   (spec_decode not in (None, "off", False), "spec_decode",
                    "speculative decode"),
                   (mesh is not None, "a device mesh", "MoE with TP/EP"),
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
        self.last_token = np.zeros(max_slots, np.int32)
        self.finished: list[Request] = []
        self._rid = itertools.count()
        self.stats = {"ticks": 0, "tokens": 0, "prefills": 0,
                      "chunk_prefills": 0, "preemptions": 0,
                      "prefix_hits": 0, "prefix_hit_tokens": 0,
                      "cow_copies": 0, "evictions": 0, "pages_high_water": 0,
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
        """Enqueue one greedy request; returns its rid."""
        if sampler is not None:
            raise _not_ported("a per-request sampler", "seeded sampling")
        if seed is not None:
            raise _not_ported("a per-request seed", "seeded sampling")
        if encoder_input is not None:
            raise _not_ported("encoder_input", "multimodal")
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) >= self.max_len:
            raise ValueError(
                f"prompt length {len(prompt)} >= max_len {self.max_len}")
        req = Request(next(self._rid), prompt, max_new_tokens, eos_id)
        req.submitted_at = time.perf_counter()
        self.sched.submit(req)
        return req.rid

    def _greedy(self, logits) -> np.ndarray:
        return greedy(logits, true_vocab=self.model.cfg.vocab).cpu().numpy()

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

    def _commit_decode(self, live, logits) -> None:
        self.stats["ticks"] += 1
        nxt = self._greedy(logits[:, -1])
        for slot in live:
            req = self.sched.slot_req[slot]
            tok = int(nxt[slot])
            req.output.append(tok)
            self.last_token[slot] = tok
            self.sched.lengths[slot] += 1
            self.stats["tokens"] += 1
            self._check_retire(slot, tok)

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
        return int(self._greedy(logits[0, -1]))

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
        if live:
            # may preempt the youngest and/or schedule copy-on-write moves
            _, cow, _ = self.sched.ensure_decode_pages()
            live = self.sched.live_slots()
            cow = [(s, a, b) for s, a, b in cow
                   if self.sched.slot_req[s] is not None]
        self.stats["preemptions"] = self.sched.preemptions
        if live:
            ps = self.pool.page_size
            B = self.max_slots
            wpages = np.full(B, self.pool.trash_page, np.int32)
            woffs = np.zeros(B, np.int32)
            lens = np.zeros(B, np.int32)
            toks = np.zeros((B, 1), np.int32)
            for slot in live:
                ln = int(self.sched.lengths[slot])
                lens[slot] = ln
                toks[slot, 0] = self.last_token[slot]
                wpages[slot] = self.sched.table[slot, ln // ps]
                woffs[slot] = ln % ps
            try:
                if cow:         # copies strictly before this tick's writes
                    PG.copy_pages(self.pool.storage, self.pool.leaf_specs,
                                  self._dev([a for _, a, _ in cow]),
                                  self._dev([b for _, _, b in cow]))
                logits = self.model.paged_decode_step(
                    self.params, self.pool.storage,
                    self._dev(self.sched.table), self._dev(lens),
                    self._dev(toks), self._dev(wpages), self._dev(woffs),
                    **self._paged_kw)
                self._commit_decode(live, logits)
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
        self._raise_or_record(errors)
        return bool(live) or self.sched.has_work()

    # -- dense tick ------------------------------------------------------------

    def _prefill_one(self, job):
        """One request's whole-prompt prefill and first token: a
        self-contained farm task (it writes nothing the engine holds).
        Returns the prefill's (B = 1) decode state and the token."""
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
        return state, int(self._greedy(logits[0, -1]))

    def _tick_dense(self) -> bool:
        _, rejects = self.sched.admit()
        errors = self._reject_errors(rejects)

        jobs = self.sched.next_chunks()          # dense: whole-prompt jobs
        if jobs:
            def guarded(job):
                # isolate failures so one bad request cannot drop the
                # other concurrently admitted requests
                try:
                    return self._prefill_one(job)
                except Exception as e:                      # noqa: BLE001
                    return e

            results, _ = self._prefill_farm.map_callables(
                [functools.partial(guarded, job) for job in jobs])
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
                self._commit_decode(live, logits)
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
