"""The port's page pool and scheduler in lockstep with the reference's.

Random admit / chunk / decode / retire / preempt / late-submit /
verify-window interleavings (hypothesis, or the deterministic stub) drive a
reference ``PagePool`` + ``Scheduler`` and the port's pair side by side.
After every step the two must hold the same state — refcounts, free-list
order, prefix-cache partition, page tables, slot status, queue order and
counters — and the port's pool must conserve its pages.  The reference's
own property tests (``test_sched_props.py``) check its invariants; the
lockstep carries them over to the port.

The disaggregated drive does the same with two pools a package (prefiller
and decoder, int8 leaf layout with its scale leaf) and ``KVHandoff``
packets between them: page conservation on both pools after every step,
with a packet's in-flight references counted as held, and a delivered
packet released twice (the second a no-op)."""
from collections import Counter

import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import given, settings, strategies as st

from repro.serve import quant as JQZ
from repro.serve.pages import KVHandoff as JaxKVHandoff
from repro.serve.pages import PagePool as JaxPagePool
from repro.serve.pages import PagedLeafSpec as JaxPagedLeafSpec
from repro.serve.scheduler import Scheduler as JaxScheduler
from repro_torch.serve import quant as QZ
from repro_torch.serve.pages import KVHandoff, PagePool, PagedLeafSpec
from repro_torch.serve.scheduler import FREE, LIVE, Scheduler

NUM_PAGES, PAGE_SIZE, SLOTS, MAX_LEN = 8, 4, 3, 32


class _Req:
    def __init__(self, rid, n):
        self.rid = rid
        self.prompt = np.arange(n, dtype=np.int32)
        self.output: list = []


def _pair(prefix_cache):
    jpool = JaxPagePool({"k": JaxPagedLeafSpec((1,), (1, 1), jnp.float32)},
                        num_pages=NUM_PAGES, page_size=PAGE_SIZE,
                        prefix_cache=prefix_cache)
    tpool = PagePool({"k": PagedLeafSpec((1,), (1, 1), torch.float32)},
                     num_pages=NUM_PAGES, page_size=PAGE_SIZE, device="cpu",
                     prefix_cache=prefix_cache)
    kw = dict(max_slots=SLOTS, max_len=MAX_LEN, prefill_chunk=PAGE_SIZE,
              chunks_per_tick=2)
    return (jpool, JaxScheduler(pool=jpool, **kw)), \
        (tpool, Scheduler(pool=tpool, **kw))


def _state(pool, s):
    return dict(
        ref=[pool.ref(p) for p in range(pool.num_pages)],
        free=list(pool._free), cached=pool.pages_cached,
        registered=(None if pool.prefix is None
                    else sorted(pool.prefix._by_page)),
        evictions=pool.evictions, high_water=pool.high_water,
        table=s.table.tolist(), n_pages=s.n_pages.tolist(),
        status=list(s.status), lengths=s.lengths.tolist(),
        slot_rids=[None if r is None else r.rid for r in s.slot_req],
        queue=[r.rid for r in s.queue], preemptions=s.preemptions,
        prefix_hits=s.prefix_hits, hit_tokens=s.prefix_hit_tokens,
        cow=s.cow_copies)


def _conserved(pool, s):
    assert pool.pages_free + pool.pages_cached + pool.pages_in_use \
        == pool.num_pages
    assert s.held_pages() == sum(pool.ref(p) for p in range(pool.num_pages))
    for slot in range(s.max_slots):
        if s.status[slot] == FREE:
            assert int(s.n_pages[slot]) == 0


def _step(a, pool, s, rid, n_late, n_spec):
    """Apply action ``a``; returns what the step emitted, for comparison."""
    if a == 0:
        admits, rejects = s.admit()
        return [(slot, r.rid) for slot, r in admits], [r.rid for r in rejects]
    if a == 1:
        jobs = s.next_chunks()
        for job in jobs:
            s.chunk_done(job)
        return [(j.slot, j.start, j.tokens.tolist(), j.pages.tolist(),
                 j.is_last) for j in jobs]
    if a == 2:
        for slot in s.live_slots():
            if int(s.lengths[slot]) < s.max_len - 1:
                s.lengths[slot] += 1
        try:
            pre, cow, _ = s.ensure_decode_pages()
        except RuntimeError as e:
            return str(e)
        return [(slot, r.rid) for slot, r in pre], cow
    if a == 3:
        live = s.live_slots()
        if live:
            s.release(min(live, key=lambda sl: s.admitted_at[sl]))
        return None
    if a == 4:
        resident = [sl for sl in range(s.max_slots) if s.status[sl] != FREE]
        if len(resident) > 1:
            return s.preempt(max(resident,
                                 key=lambda sl: s.admitted_at[sl])).rid
        return None
    if a == 5:
        s.submit(_Req(rid, 1 + (n_late * 7) % (MAX_LEN // 2)))
        return None
    want = {sl: 1 + (n_spec + sl) % 3 for sl in s.live_slots()
            if int(s.lengths[sl]) + 4 < s.max_len - 1}
    try:
        _, cow, granted = s.ensure_decode_pages(extra=want)
    except RuntimeError as e:
        return str(e)
    for sl in want:
        if s.status[sl] != LIVE:
            continue
        s.lengths[sl] += (n_spec + sl) % (granted.get(sl, 0) + 1) + 1
        s.rollback_verify_pages(sl)
    return cow, granted


def _lockstep(actions, plens, prefix_cache):
    (jpool, js), (tpool, ts) = _pair(prefix_cache)
    for i, n in enumerate(plens):
        js.submit(_Req(i, n))
        ts.submit(_Req(i, n))
    rid, n_late, n_spec = len(plens), 0, 0
    for a in actions:
        if a == 5:
            n_late += 1
        if a == 6:
            n_spec += 1
        want = _step(a, jpool, js, rid, n_late, n_spec)
        got = _step(a, tpool, ts, rid, n_late, n_spec)
        if a == 5:
            rid += 1
        assert got == want, (a, got, want)
        assert _state(tpool, ts) == _state(jpool, js), a
        _conserved(tpool, ts)


@settings(max_examples=20, deadline=None)
@given(st.lists(st.integers(0, 6), min_size=1, max_size=60),
       st.lists(st.integers(1, 20), min_size=1, max_size=8))
def test_pool_and_scheduler_lockstep(actions, plens):
    _lockstep(actions, plens, prefix_cache=False)


@settings(max_examples=20, deadline=None)
@given(st.lists(st.integers(0, 6), min_size=1, max_size=60),
       st.lists(st.integers(1, 20), min_size=1, max_size=8))
def test_pool_and_scheduler_lockstep_with_prefix_cache(actions, plens):
    """Sharing in play: equal-length prompts (equal content) match, park,
    get LRU-evicted and copy-on-write, identically in both packages."""
    _lockstep(actions, plens, prefix_cache=True)


# -- disaggregated prefill/decode: two pools and KVHandoff packets -----------

def _disagg_side(port, prefix_cache):
    """One package's (pool, scheduler) in the int8 leaf layout."""
    if port:
        specs = QZ.quantize_leaf_specs(
            {"k": PagedLeafSpec((1,), (1, 1), torch.float32)},
            QZ.Int8KVQuant())
        pool = PagePool(specs, num_pages=NUM_PAGES, page_size=PAGE_SIZE,
                        device="cpu", prefix_cache=prefix_cache)
        sched = Scheduler
    else:
        specs = JQZ.quantize_leaf_specs(
            {"k": JaxPagedLeafSpec((1,), (1, 1), jnp.float32)},
            JQZ.Int8KVQuant())
        pool = JaxPagePool(specs, num_pages=NUM_PAGES, page_size=PAGE_SIZE,
                           prefix_cache=prefix_cache)
        sched = JaxScheduler
    return pool, sched(max_slots=SLOTS, max_len=MAX_LEN, pool=pool,
                       prefill_chunk=PAGE_SIZE, chunks_per_tick=2)


def _held(pool, s, extra):
    """The reference's conservation check, with ``extra`` (page -> refs)
    the in-flight packets' references outside any slot table."""
    refs = [pool.ref(p) for p in range(pool.num_pages)]
    cnt = Counter(int(p) for slot in range(s.max_slots)
                  for p in s.table[slot, :int(s.n_pages[slot])])
    cnt.update(extra)
    assert all(cnt.get(p, 0) == refs[p] for p in range(pool.num_pages))
    assert s.held_pages() + sum(extra.values()) == sum(refs)
    free = {int(p) for p in pool._free}
    assert len(free) == pool.pages_free
    cached = {p for p in range(pool.num_pages) if refs[p] == 0
              and pool.prefix is not None and p in pool.prefix}
    held = {p for p in range(pool.num_pages) if refs[p] > 0}
    assert not (free & cached) and not (free & held) and not (cached & held)
    assert free | cached | held == set(range(pool.num_pages))
    assert pool.pages_cached == len(cached)
    for slot in range(s.max_slots):
        if s.status[slot] == FREE:
            assert int(s.n_pages[slot]) == 0


def _drive_disagg(actions, plens, prefix_cache, port):
    """The reference's ``_drive_disagg`` on one package: returns the
    per-step states of both sides, the pending packets and both sides."""
    (pool_p, sp), (pool_d, sd) = (_disagg_side(port, prefix_cache)
                                  for _ in range(2))
    handoff = KVHandoff if port else JaxKVHandoff
    pending = []
    rid = iter(range(1_000_000))
    for n in plens:
        sp.submit(_Req(next(rid), n))
    n_late, trace = 0, []
    for a in actions:
        if a == 0:
            sp.admit()
        elif a == 1:
            for job in sp.next_chunks():
                sp.chunk_done(job)
                if job.is_last:
                    total = int(sp.lengths[job.slot])
                    pages = [int(p) for p in
                             sp.table[job.slot, :-(-total // sp.page_size)]]
                    pool_p.incref(pages)        # the in-flight references
                    sp.release(job.slot)
                    pending.append(handoff(req=job.req, length=total, kv=None,
                                           pages=pages, pool=pool_p))
        elif a == 2 and pending:                # deliver the oldest packet
            pkt = pending[0]
            slot = next((x for x in range(sd.max_slots)
                         if sd.status[x] == FREE), None)
            if slot is not None:
                ps = sd.page_size
                pages = pool_d.alloc((pkt.length + ps) // ps)
                if pages is not None:
                    sd.bind_prefilled(slot, pkt.req, pages, pkt.length)
                    pkt.release()
                    pkt.release()               # must be a no-op
                    pending.pop(0)
        elif a == 3:
            for slot in sd.live_slots():
                if int(sd.lengths[slot]) < sd.max_len - 1:
                    sd.lengths[slot] += 1
            try:
                sd.ensure_decode_pages()
            except RuntimeError:
                pass
        elif a == 4:
            live = sd.live_slots()
            if live:
                sd.release(min(live, key=lambda sl: sd.admitted_at[sl]))
        elif a == 5:
            resident = [sl for sl in range(sp.max_slots)
                        if sp.status[sl] != FREE]
            if resident:
                sp.preempt(max(resident, key=lambda sl: sp.admitted_at[sl]))
        elif a == 6:
            resident = [sl for sl in range(sd.max_slots)
                        if sd.status[sl] != FREE]
            if resident:
                sd.preempt(max(resident, key=lambda sl: sd.admitted_at[sl]))
            sd.admit()
        else:
            n_late += 1
            sp.submit(_Req(next(rid), 1 + (n_late * 7) % (MAX_LEN // 2)))
        inflight = Counter(p for pkt in pending if not pkt.released
                           for p in pkt.pages)
        if port:
            _held(pool_p, sp, inflight)
            _held(pool_d, sd, Counter())
        trace.append((_state(pool_p, sp), _state(pool_d, sd),
                      [(pkt.req.rid, pkt.length, pkt.pages) for pkt in pending]))
    return trace, pending, (pool_p, sp), (pool_d, sd)


@settings(max_examples=20, deadline=None)
@given(st.lists(st.integers(0, 7), min_size=1, max_size=60),
       st.lists(st.integers(1, 20), min_size=1, max_size=8),
       st.booleans())
def test_handoff_page_conservation(actions, plens, prefix_cache):
    """Random prefill / handoff / deliver / decode / preempt interleavings
    conserve pages on both of the port's pools, with in-flight packet
    references counted as held on the prefiller, step for step in the
    reference's states."""
    want = _drive_disagg(actions, plens, prefix_cache, port=False)[0]
    got = _drive_disagg(actions, plens, prefix_cache, port=True)[0]
    assert got == want


@settings(max_examples=20, deadline=None)
@given(st.lists(st.integers(0, 7), min_size=10, max_size=60),
       st.lists(st.integers(1, 20), min_size=2, max_size=8),
       st.booleans())
def test_handoff_drain_returns_every_page(actions, plens, prefix_cache):
    """After releasing every in-flight packet (twice) and every resident
    slot on both sides, both of the port's pools are whole again."""
    _, pending, *sides = _drive_disagg(actions, plens, prefix_cache,
                                       port=True)
    for pkt in pending:
        pkt.release()
        pkt.release()
    for pool, s in sides:
        for slot in range(s.max_slots):
            if s.status[slot] != FREE:
                s.release(slot)
        assert s.held_pages() == 0
        assert pool.pages_free + pool.pages_cached == pool.num_pages
        pool.flush_cache()
        assert pool.pages_free == pool.num_pages and pool.pages_cached == 0
