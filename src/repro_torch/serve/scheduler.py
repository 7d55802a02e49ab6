"""Serving policy: admission, chunked prefill, and preemption.

Split out of :class:`repro.serve.engine.ServeEngine` so the engine is pure
*execution* (jitted device calls) and this module is pure *policy* (host
bookkeeping) — the same function-centric cut the runtime makes between task
functions and farm machinery.  The scheduler never touches device arrays;
it hands the engine a plan (admissions, prefill chunk jobs, page/offset
targets) and the engine reports back what actually ran.

Five mechanisms:

* **Admission with prefix reuse** — FIFO from the queue into free slots.
  In paged mode the longest cached prefix of the prompt is matched in the
  pool's radix index first (those pages are incref'd, not copied) and only
  the *uncached remainder* is allocated all-or-nothing — deterministic and
  starvation-free: the queue head blocks until pages drain.
* **Chunked prefill from the match boundary** — prompts prefill in
  fixed-size, page-aligned chunks interleaved with decode ticks; fully
  cached pages are skipped entirely (chunking starts where the match
  ends).  When the WHOLE prompt is cached, one *replay* chunk recomputes
  the last page's positions with its K/V writes routed to the trash page —
  attention reads the shared pages, producing the first-token logits
  without recomputing (or mutating) anything cached.  ``chunks_per_tick``
  bounds prefill compute per tick; chunks round-robin across slots.
* **Copy-on-write decode** — a decode write targeting a page with
  refcount > 1 first copies it into a fresh exclusive page (the sharer
  keeps the original); targeting a *registered* page this slot holds alone
  just unregisters it and writes in place.  A shared page is never
  mutated.
* **Speculative verify windows** — ``ensure_decode_pages(extra=...)``
  reserves exclusive write targets for a slot's next 1 + n positions so a
  batched verify can commit draft K/V; the extras are best-effort (never
  preempting — speculation cannot evict a request plain decode would have
  kept) and ``rollback_verify_pages`` returns whatever the accepted
  tokens didn't need straight to the free list.
* **Preemption on page exhaustion** — when a live slot needs a fresh page
  and the pool is dry (after LRU eviction of unreferenced cached pages),
  the youngest-admitted request is evicted (vLLM-style recompute: its
  references are dropped — full clean pages park in the prefix cache —
  and it re-enters the queue head; on re-admission it re-prefills prompt
  *plus* tokens generated so far, usually re-matching its own parked
  pages, which preserves greedy token streams exactly).
"""

from __future__ import annotations

__all__ = ["FREE", "LIVE", "PREFILL",
           "ChunkJob", "EncodeJob", "Scheduler",
           "prefill_tokens"]

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.serve.pages import PagePool

FREE, PREFILL, LIVE = "free", "prefill", "live"


def prefill_tokens(req) -> np.ndarray:
    """The token sequence a (possibly resumed) request must prefill:
    encoder pseudo-tokens (the VLM image prefix — negative ids hashed from
    the embedding content, see
    :func:`repro.serve.engine.encoder_prefix_tokens`), then the prompt,
    then anything generated before a preemption.  Because the pseudo-tokens
    ARE ordinary (negative) int32s, admission, prefix matching, page
    registration, chunking, replay and release all treat an image prefix
    exactly like text — zero special cases downstream."""
    toks = np.asarray(req.prompt, np.int32)
    enc = getattr(req, "encoder_tokens", None)
    if enc is not None:
        toks = np.concatenate([np.asarray(enc, np.int32), toks])
    if req.output:
        toks = np.concatenate([toks, np.asarray(req.output, np.int32)])
    return toks


@dataclasses.dataclass
class ChunkJob:
    """One page-aligned prefill chunk for one slot."""
    slot: int
    req: object
    tokens: np.ndarray          # (C,) int32, right-padded to the chunk size
    start: int                  # absolute position of tokens[0]
    n_valid: int                # real (non-pad) tokens in this chunk
    pages: Optional[np.ndarray]  # (C // page_size,) page ids; None = dense
    is_last: bool
    total: int                  # full prefill length of the request
    embeds: Optional[np.ndarray] = None   # (C, d) rows for pseudo-tokens


@dataclasses.dataclass
class EncodeJob:
    """One audio chunk for the streaming encoder (enc-dec slots only).

    The engine runs the bidirectional encoder over ``frames`` through the
    Executor protocol, projects cross K/V, and scatters it into ``pages``
    of the cross pool; the slot's decoder prefill chunks are held back
    until every encode job has committed."""
    slot: int
    req: object
    frames: np.ndarray          # (Cf, d) f32, right-padded to the chunk
    start: int                  # absolute frame position of frames[0]
    n_valid: int                # real (non-pad) frames in this chunk
    pages: np.ndarray           # (Cf // cross_page_size,) cross page ids


class Scheduler:
    """Serving policy, all host-side numpy: FIFO admission with all-or-
    nothing page allocation (self-KV and, for enc-dec, cross-KV), prefix-
    cache matching, per-tick encode/prefill chunk planning, decode-page
    growth, and recompute-flavor preemption.  The engine executes the
    jobs this class plans; it never touches device memory itself."""

    def __init__(self, *, max_slots: int, max_len: int,
                 pool: Optional[PagePool] = None, prefill_chunk: int = 64,
                 chunks_per_tick: int = 2,
                 cross_pool: Optional[PagePool] = None, max_frames: int = 0):
        self.max_slots, self.max_len = max_slots, max_len
        self.pool = pool
        self.queue: list = []
        self.status = [FREE] * max_slots
        self.slot_req: list = [None] * max_slots
        self.lengths = np.zeros(max_slots, np.int64)
        self.prefill_done = np.zeros(max_slots, np.int64)
        self.prefill_total = np.zeros(max_slots, np.int64)
        self.admitted_at = np.zeros(max_slots, np.int64)
        self._admit_seq = 0
        self._rr = 0
        self.preemptions = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.cow_copies = 0
        self.chunks_per_tick = max(1, chunks_per_tick)
        if pool is not None:
            ps = pool.page_size
            self.page_size = ps
            self.prefill_chunk = max(ps, ((prefill_chunk + ps - 1) // ps) * ps)
            self.pages_per_slot = (max_len + ps - 1) // ps
            if pool.num_pages < self.pages_per_slot:
                raise ValueError(
                    f"pool of {pool.num_pages} pages cannot hold one "
                    f"max_len={max_len} request ({self.pages_per_slot} pages)")
            self.table = np.zeros((max_slots, self.pages_per_slot), np.int32)
            self.n_pages = np.zeros(max_slots, np.int64)
            self.replay = np.zeros(max_slots, bool)
        else:
            self.page_size = None
            self.prefill_chunk = prefill_chunk
            self.table = None
            self.n_pages = None
        # enc-dec: a second, read-only page table per slot for cross-KV
        self.cross_pool = cross_pool
        if cross_pool is not None:
            assert pool is not None, "cross-KV pages require a paged pool"
            cps = cross_pool.page_size
            self.cross_page_size = cps
            self.encode_chunk = max(
                cps, ((self.prefill_chunk + cps - 1) // cps) * cps)
            self.cross_pages_per_slot = max(1, (max_frames + cps - 1) // cps)
            if cross_pool.num_pages < self.cross_pages_per_slot:
                raise ValueError(
                    f"cross pool of {cross_pool.num_pages} pages cannot hold "
                    f"one max_frames={max_frames} request "
                    f"({self.cross_pages_per_slot} pages)")
            self.cross_table = np.zeros(
                (max_slots, self.cross_pages_per_slot), np.int32)
            self.cross_n = np.zeros(max_slots, np.int64)
            self.enc_total = np.zeros(max_slots, np.int64)
            self.enc_done = np.zeros(max_slots, np.int64)

    # -- queries -------------------------------------------------------------

    def live_slots(self) -> list[int]:
        """Slots currently decoding."""
        return [s for s in range(self.max_slots) if self.status[s] == LIVE]

    def prefilling_slots(self) -> list[int]:
        """Slots still consuming prefill (or encode) chunks."""
        return [s for s in range(self.max_slots) if self.status[s] == PREFILL]

    def has_work(self) -> bool:
        """True while anything is queued or resident."""
        return bool(self.queue) or any(s != FREE for s in self.status)

    def held_pages(self) -> int:
        """Page *references* currently held by slots (a page shared by k
        slots counts k times — it equals the sum of pool refcounts).  The
        conservation invariant — checked by the property tests — is
        ``pool.pages_free + pool.pages_cached + pool.pages_in_use ==
        pool.num_pages`` with ``held_pages() == sum of refcounts`` at every
        point where control returns to the caller."""
        return int(self.n_pages.sum()) if self.pool is not None else 0

    def held_cross_pages(self) -> int:
        """Cross-KV page references held by slots.  Cross pages are never
        shared (no prefix cache on the cross pool), so this equals
        ``cross_pool.pages_in_use`` whenever control is with the caller —
        the conservation check the preemption property tests assert."""
        return int(self.cross_n.sum()) if self.cross_pool is not None else 0

    # -- admission -----------------------------------------------------------

    def submit(self, req) -> None:
        """Append to the admission FIFO (no validation here)."""
        self.queue.append(req)

    def admit(self) -> tuple[list[tuple[int, object]], list[object]]:
        """Fill free slots FIFO.  Returns (admitted (slot, req) pairs,
        rejected requests whose prefill can never fit ``max_len`` — these
        bypassed submit()'s validation and must be retired by the caller)."""
        admits, rejects = [], []
        for slot in range(self.max_slots):
            if not self.queue:
                break
            if self.status[slot] != FREE:
                continue
            req = self.queue[0]
            toks = prefill_tokens(req)
            total = len(toks)
            if total == 0 or total >= self.max_len:
                # can never prefill: nothing to chunk / no room to decode
                self.queue.pop(0)
                rejects.append(req)
                continue
            cached_tok = 0
            if self.pool is not None:
                # pages for every prefill position (padded to page_size)
                # plus the first decode token: ceil((total + 1) / page_size)
                ps = self.page_size
                need = (total + ps) // ps
                cached: list[int] = []
                if self.pool.prefix is not None:
                    cached, cached_tok = self.pool.prefix.match(toks)
                # incref BEFORE allocating the tail so the eviction the
                # alloc may trigger can never take our matched pages
                self.pool.incref(cached)
                tail = self.pool.alloc(need - len(cached))
                if tail is None:
                    self.pool.decref(cached)    # back to parked / shared
                    break                       # queue head waits for pages
                if self.cross_pool is not None:
                    # all-or-nothing across BOTH pools: the cross pages for
                    # every audio frame allocate with the self pages or the
                    # whole admission rolls back
                    frames = getattr(req, "encoder_input", None)
                    n_frames = 0 if frames is None else len(frames)
                    cps = self.cross_page_size
                    cneed = (n_frames + cps - 1) // cps
                    cross = self.cross_pool.alloc(cneed)
                    if cross is None:
                        self.pool.decref(cached + tail)
                        break
                    self.cross_table[slot, :cneed] = cross
                    self.cross_n[slot] = cneed
                    self.enc_total[slot] = n_frames
                    self.enc_done[slot] = 0
                self.table[slot, :need] = cached + tail
                self.n_pages[slot] = need
                self.replay[slot] = cached_tok == total
                if cached_tok:
                    self.prefix_hits += 1
                    self.prefix_hit_tokens += cached_tok
            self.queue.pop(0)
            self.status[slot] = PREFILL
            self.slot_req[slot] = req
            self.lengths[slot] = 0
            # chunking starts at the match boundary (page-aligned); a fully
            # cached prompt still replays its last page for the first-token
            # logits (writes routed to the trash page — see _make_job)
            if self.pool is not None and self.replay[slot]:
                self.prefill_done[slot] = (total - 1) // ps * ps
            else:
                self.prefill_done[slot] = cached_tok
            self.prefill_total[slot] = total
            self.admitted_at[slot] = self._admit_seq
            self._admit_seq += 1
            admits.append((slot, req))
        return admits, rejects

    def bind_prefilled(self, slot: int, req, pages, length: int) -> None:
        """Admit an externally prefilled request straight into a LIVE slot —
        the decoder half of a prefill/decode page handoff.  The caller has
        already allocated ``pages`` all-or-nothing (enough for every
        prefilled position plus the next decode write:
        ``(length + page_size) // page_size``) and scattered the KV into the
        leading ``ceil(length / page_size)`` of them; this binds the same
        bookkeeping :meth:`admit` + :meth:`chunk_done` would have, including
        registering the full clean pages in the prefix index so later
        admissions share them and decode writes take the usual
        unregister-or-COW path."""
        assert self.pool is not None, "page handoff requires a paged pool"
        assert self.status[slot] == FREE, (slot, self.status[slot])
        n = len(pages)
        self.table[slot, :n] = pages
        self.n_pages[slot] = n
        self.replay[slot] = False
        self.status[slot] = LIVE
        self.slot_req[slot] = req
        self.lengths[slot] = length
        self.prefill_done[slot] = length
        self.prefill_total[slot] = length
        self.admitted_at[slot] = self._admit_seq
        self._admit_seq += 1
        self._register_pages(slot, length)

    # -- chunked prefill -----------------------------------------------------

    def _padded_total(self, slot: int) -> int:
        if self.pool is None:
            return int(self.prefill_total[slot])
        ps = self.page_size
        return (int(self.prefill_total[slot]) + ps - 1) // ps * ps

    def _make_job(self, slot: int, start: int) -> ChunkJob:
        req = self.slot_req[slot]
        total = int(self.prefill_total[slot])
        padded = self._padded_total(slot)
        C = min(self.prefill_chunk, padded - start) if self.pool is not None \
            else total
        toks = np.zeros(C, np.int32)
        valid = max(0, min(C, total - start))
        toks[:valid] = prefill_tokens(req)[start:start + valid]
        pages = None
        if self.pool is not None:
            ps = self.page_size
            if self.replay[slot]:
                # fully cached prompt: recompute the last page's positions
                # for their logits but write the (identical) K/V to the
                # trash page — the shared pages are read-only to us
                pages = np.full((start + C) // ps - start // ps,
                                self.pool.trash_page, np.int32)
            else:
                pages = self.table[slot, start // ps:(start + C) // ps].copy()
        # VLM image prefix: rows of the precomputed embeddings ride along
        # with the chunk that covers their (negative pseudo-token) positions
        embeds = None
        enc_tok = getattr(req, "encoder_tokens", None)
        enc_inp = getattr(req, "encoder_input", None)
        if enc_tok is not None and enc_inp is not None \
                and start < len(enc_tok):
            enc_inp = np.asarray(enc_inp, np.float32)
            buf = np.zeros((C, enc_inp.shape[-1]), np.float32)
            take = min(C, len(enc_tok) - start)
            buf[:take] = enc_inp[start:start + take]
            embeds = buf
        return ChunkJob(slot=slot, req=req, tokens=toks, start=start,
                        n_valid=valid, pages=pages,
                        is_last=start + C >= padded, total=total,
                        embeds=embeds)

    def _padded_enc_total(self, slot: int) -> int:
        cps = self.cross_page_size
        return (int(self.enc_total[slot]) + cps - 1) // cps * cps

    def _make_encode_job(self, slot: int, start: int) -> EncodeJob:
        req = self.slot_req[slot]
        total = int(self.enc_total[slot])
        padded = self._padded_enc_total(slot)
        cps = self.cross_page_size
        C = min(self.encode_chunk, padded - start)
        frames = np.asarray(req.encoder_input, np.float32)
        valid = max(0, min(C, total - start))
        buf = np.zeros((C, frames.shape[-1]), np.float32)
        buf[:valid] = frames[start:start + valid]
        pages = self.cross_table[slot, start // cps:(start + C) // cps].copy()
        return EncodeJob(slot=slot, req=req, frames=buf, start=start,
                         n_valid=valid, pages=pages)

    def next_chunks(self) -> list:
        """Plan this tick's prefill work.  Dense mode: every prefilling slot
        gets its whole prompt as one job (they run concurrently on the
        engine's farm).  Paged mode: up to ``chunks_per_tick`` page-aligned
        chunks, round-robin across prefilling slots.  Enc-dec slots emit
        their :class:`EncodeJob` audio chunks first (counted against the
        same budget); decoder :class:`ChunkJob` chunks follow only once the
        whole clip is planned — the engine commits encode jobs before
        prompt chunks inside a tick, so cross-KV pages are always written
        before the first decoder read."""
        slots = self.prefilling_slots()
        if not slots:
            return []
        if self.pool is None:
            return [self._make_job(s, 0) for s in slots]
        jobs: list = []
        planned = {s: int(self.prefill_done[s]) for s in slots}
        enc_planned = {s: int(self.enc_done[s]) for s in slots} \
            if self.cross_pool is not None else {}
        i = 0
        order = sorted(slots, key=lambda s: (s - self._rr) % self.max_slots)

        def pending(s):
            if self.cross_pool is not None \
                    and enc_planned[s] < self._padded_enc_total(s):
                return True
            return planned[s] < self._padded_total(s)

        while len(jobs) < self.chunks_per_tick:
            ready = [s for s in order if pending(s)]
            if not ready:
                break
            slot = ready[i % len(ready)]
            if self.cross_pool is not None \
                    and enc_planned[slot] < self._padded_enc_total(slot):
                job = self._make_encode_job(slot, enc_planned[slot])
                enc_planned[slot] += len(job.frames)
            else:
                job = self._make_job(slot, planned[slot])
                planned[slot] += len(job.tokens)
            jobs.append(job)
            i += 1
        if jobs:
            self._rr = (jobs[-1].slot + 1) % self.max_slots
        return jobs

    def _register_pages(self, slot: int, valid: int, start: int = 0) -> None:
        """Insert every FULL page in ``[start, valid)`` whose content is
        final (all ``page_size`` positions written with known tokens) into
        the prefix index.  First registration wins.  Callers pass ``start``
        to cover only newly-written pages — earlier ones were registered
        when their chunk committed (or came from the cache)."""
        pool = self.pool
        if pool is None or pool.prefix is None:
            return
        req = self.slot_req[slot]
        if req is None:
            return
        toks = prefill_tokens(req)
        for i in range(start // self.page_size,
                       min(valid, len(toks)) // self.page_size):
            pool.prefix.insert(toks, i, int(self.table[slot, i]))

    def encode_done(self, job: EncodeJob) -> None:
        """An audio chunk's cross K/V has been scattered into its pages."""
        self.enc_done[job.slot] = job.start + len(job.frames)

    def chunk_done(self, job: ChunkJob) -> None:
        """Commit one prefill chunk: advance progress, register now-full
        clean pages for prefix sharing, flip the slot LIVE on the last."""
        slot = job.slot
        self.prefill_done[slot] = job.start + len(job.tokens)
        if self.pool is not None and not self.replay[slot]:
            self._register_pages(slot, job.start + job.n_valid,
                                 start=job.start)
        if job.is_last:
            self.status[slot] = LIVE
            self.lengths[slot] = job.total

    # -- decode page accounting: growth, COW, preemption ---------------------

    def _alloc_or_preempt(self, slot: int,
                          preempted: list) -> Optional[list[int]]:
        """One page for ``slot``, preempting youngest-admitted requests
        (never ``slot`` itself) until the pool yields.  Returns None only
        in the COW retry loop's favor: after a preemption the caller must
        re-check sharing, since the victim's release may have dropped the
        refcount that made the copy necessary."""
        page = self.pool.alloc(1)
        if page is not None:
            return page
        victim = self._youngest_victim(exclude=slot)
        if victim is None:
            raise RuntimeError(
                "page pool exhausted with a single request resident; "
                "num_pages is too small for max_len")
        preempted.append((victim, self.preempt(victim)))
        return None

    def _ensure_exclusive(self, slot: int, idx: int, preempted, cow,
                          allow_preempt: bool) -> bool:
        """Make page ``idx`` of ``slot`` an exclusive write target.  Three
        cases: the index is past the slot's last page (allocate fresh), the
        page is shared with another holder (copy-on-write: allocate a copy,
        drop our reference to the original), or it is a registered page we
        hold alone (unregister and write in place — no copy needed).
        ``allow_preempt=False`` makes allocation best-effort (returns False
        on pool exhaustion instead of evicting a victim) — speculative
        verify windows never preempt anyone for their extra positions."""
        if idx >= int(self.n_pages[slot]):
            assert idx == int(self.n_pages[slot]), (slot, idx)
            if allow_preempt:
                page = None
                while page is None:
                    page = self._alloc_or_preempt(slot, preempted)
            else:
                page = self.pool.alloc(1)
                if page is None:
                    return False
            self.table[slot, idx] = page[0]
            self.n_pages[slot] += 1
            return True                         # fresh page: exclusive
        p = int(self.table[slot, idx])
        while self.pool.ref(p) > 1:             # shared: copy before writing
            if allow_preempt:
                dst = self._alloc_or_preempt(slot, preempted)
                if dst is None:
                    continue        # a victim released; re-check the ref
            else:
                dst = self.pool.alloc(1)
                if dst is None:
                    return False
            cow.append((slot, p, dst[0]))
            self.pool.decref([p])               # sharers keep the original
            self.table[slot, idx] = dst[0]
            self.cow_copies += 1
            p = dst[0]
        if self.pool.prefix is not None and p in self.pool.prefix:
            # sole holder of a registered page: writing would corrupt
            # future matches — drop it (and descendants) from the index
            self.pool.unregister(p)
        return True

    def ensure_decode_pages(self, extra=None):
        """Guarantee every live slot owns — *exclusively* — the page its
        next token writes into, preempting the youngest-admitted request
        when the pool runs dry (see :meth:`_ensure_exclusive` for the
        allocate / copy-on-write / unregister cases).

        ``extra`` ({slot: n}) additionally secures exclusive write targets
        for ``n`` positions beyond the next token — a speculative verify
        window.  Extras are strictly best-effort: they never preempt and
        never raise, they just stop when the pool runs dry, so turning
        speculation on can never evict a request that plain decode would
        have kept resident.

        Returns (preempted (slot, req) pairs, COW (slot, src_page,
        dst_page) triples whose device copies the engine must apply before
        this tick's writes, granted {slot: m <= n} extra positions secured
        — the engine trims each slot's draft window to it; zero for every
        slot when ``extra`` is None)."""
        if self.pool is None:
            return [], [], {}
        want = extra or {}
        preempted: list[tuple[int, object]] = []
        cow: list[tuple[int, int, int]] = []
        granted: dict[int, int] = {}
        order = sorted(self.live_slots(), key=lambda s: self.admitted_at[s])
        # pass 1: every live slot's MANDATORY next-token page first, so a
        # speculative window can never consume the free page a younger
        # slot's plain decode write was entitled to
        for slot in order:
            if self.status[slot] != LIVE:       # preempted earlier this pass
                continue
            idx = int(self.lengths[slot]) // self.page_size
            if idx < self.pages_per_slot:
                self._ensure_exclusive(slot, idx, preempted, cow,
                                       allow_preempt=True)
        # pass 2: speculative extras, strictly best-effort (no preemption)
        for slot in order:
            if self.status[slot] != LIVE:
                continue
            got = 0
            for j in range(1, 1 + int(want.get(slot, 0))):
                pos = int(self.lengths[slot]) + j
                idx = pos // self.page_size
                if idx >= self.pages_per_slot:
                    break           # table capacity: window ends at max_len
                if not self._ensure_exclusive(slot, idx, preempted, cow,
                                              allow_preempt=False):
                    break
                got += 1
            granted[slot] = got
        return preempted, cow, granted

    def rollback_verify_pages(self, slot: int) -> int:
        """Return the pages a speculative verify window reserved beyond
        what the ACCEPTED tokens (plus the next decode write) need.  Called
        after the engine commits a verify's emitted tokens, with
        ``lengths[slot]`` already advanced; trimmed pages are exclusively
        held and unregistered (``_ensure_exclusive`` made them so and
        nothing registers mid-tick), so their decref goes straight to the
        free list — rejected-draft K/V is never parked in the prefix cache.
        Returns the number of pages released."""
        if self.pool is None or self.status[slot] != LIVE:
            return 0
        needed = int(self.lengths[slot]) // self.page_size + 1
        n = int(self.n_pages[slot])
        if n <= needed:
            return 0
        self.pool.decref(self.table[slot, needed:n].tolist())
        self.table[slot, needed:n] = 0
        self.n_pages[slot] = needed
        return n - needed

    def _youngest_victim(self, exclude: int) -> Optional[int]:
        cands = [s for s in range(self.max_slots)
                 if s != exclude and self.status[s] in (PREFILL, LIVE)]
        if not cands:
            return None
        return max(cands, key=lambda s: self.admitted_at[s])

    def preempt(self, slot: int):
        """Evict a request (recompute flavor): drop its page references,
        requeue it at the head.  Generated tokens stay on ``req.output``
        and are re-prefilled on re-admission — usually re-matching the
        pages it just parked — so its token stream continues exactly where
        it stopped."""
        req = self.slot_req[slot]
        self.release(slot)
        self.queue.insert(0, req)
        self.preemptions += 1
        return req

    def release(self, slot: int) -> None:
        """Walker ``delete``: the slot's page references return to the
        pool.  Full clean pages (every position written with known tokens)
        are registered first, so decref *parks* them in the prefix cache —
        a retired request's prompt stays matchable — while partial or
        shared-elsewhere pages take their usual decref path (free list /
        still held by the other sharers)."""
        if self.pool is not None and self.n_pages[slot]:
            n = int(self.n_pages[slot])
            if self.status[slot] == LIVE:
                valid = int(self.lengths[slot])
            else:       # mid-prefill: only committed chunks hold real K/V
                valid = min(int(self.prefill_done[slot]),
                            int(self.prefill_total[slot]))
            self._register_pages(slot, valid)
            self.pool.decref(self.table[slot, :n].tolist())
            self.table[slot, :n] = 0
            self.n_pages[slot] = 0
            self.replay[slot] = False
        if self.cross_pool is not None and self.cross_n[slot]:
            # cross pages are never registered/shared: decref -> free list
            nc = int(self.cross_n[slot])
            self.cross_pool.decref(self.cross_table[slot, :nc].tolist())
            self.cross_table[slot, :nc] = 0
            self.cross_n[slot] = 0
            self.enc_total[slot] = 0
            self.enc_done[slot] = 0
        self.status[slot] = FREE
        self.slot_req[slot] = None
        self.lengths[slot] = 0
        self.prefill_done[slot] = 0
        self.prefill_total[slot] = 0
