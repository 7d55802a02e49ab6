"""The port's page pool and scheduler in lockstep with the reference's.

Random admit / chunk / decode / retire / preempt / late-submit /
verify-window interleavings (hypothesis, or the deterministic stub) drive a
reference ``PagePool`` + ``Scheduler`` and the port's pair side by side.
After every step the two must hold the same state — refcounts, free-list
order, prefix-cache partition, page tables, slot status, queue order and
counters — and the port's pool must conserve its pages.  The reference's
own property tests (``test_sched_props.py``) check its invariants; the
lockstep carries them over to the port."""
import jax.numpy as jnp
import numpy as np
import torch
from hypothesis import given, settings, strategies as st

from repro.serve.pages import PagePool as JaxPagePool
from repro.serve.pages import PagedLeafSpec as JaxPagedLeafSpec
from repro.serve.scheduler import Scheduler as JaxScheduler
from repro_torch.serve.pages import PagePool, PagedLeafSpec
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
