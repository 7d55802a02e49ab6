"""Disaggregated prefill/decode serving: two engines, one page handoff.

Counterpart of ``repro.serve.disagg``.  Prefill is compute-bound (one big
batched forward over the prompt), decode is memory-bandwidth-bound (one
token a tick a slot, KV cache resident); this module splits
:class:`repro_torch.serve.engine.ServeEngine` into those roles:

* the **prefiller** — ``ServeEngine(prefill_only=True)`` — admits,
  chunk-prefills (with prefix-cache reuse), samples the first token, then
  packages each surviving request as a :class:`repro_torch.serve.pages.
  KVHandoff` instead of decoding;
* the **decoder** — an ordinary ``ServeEngine`` — receives each packet
  through :meth:`~repro_torch.serve.engine.ServeEngine.inject_prefilled`:
  the gathered KV copy (int8 payloads travel with their scale leaves) is
  scattered into freshly allocated pages of the decoder's own pool, the
  slot goes LIVE, and decode continues where the monolithic engine would
  have, with no recompute.

On one card the handoff is a copy between two pools on the same device
(a gather on the prefiller, a scatter on the decoder), not a transfer over
a link; both roles launch on the device's default stream, so the gathered
copy is complete before the decoder's scatter reads it.

The handoff rule: gather on the prefiller takes one in-flight reference per
source page; ``packet.release()`` drops them exactly once after a
successful injection, so page conservation holds on both pools at every
step, and while packets wait for decoder capacity they pin prefiller pages,
which stalls the prefiller's own admission (backpressure, no unbounded
queue between the roles).

Coordination is the paper's function-centric move: the two roles are plain
zero-argument stage functions handed to :func:`repro_torch.core.runtime.
run_stages`, so the same code runs in a fixed order on a
:class:`~repro_torch.core.runtime.SerialExecutor` (prefill stage, then
decode stage) or overlapped on a :class:`~repro_torch.core.runtime.
ThreadFarmExecutor`.  Token streams are the same either way: greedy
sampling ignores the key and a seeded request folds ``len(output)`` into
its own seed, so a token depends only on the model, the prompt and the
tokens before it.

One departure from the reference: it releases a delivered packet inside
the decode stage, which decrefs the prefiller's pool while the prefill
stage may be inside the prefiller's tick on another farm thread, and
:class:`~repro_torch.serve.pages.PagePool`'s refcount, cached-page count
and free list are read-modify-writes.  Here the decode stage only records
the delivered packets, and :meth:`DisaggServeEngine.tick` releases them
once both stages have returned, on the caller's thread: the prefiller's
pool is never touched by two threads at once.  Under the serial executor
the prefiller's pool sees the same calls in the same order as the
reference's.

A serving ``mesh=`` passes through to both roles, as the reference's
shared engine kwargs do: each role is the mesh engine, every rank serves
its shard of both, and the roles' collectives run in the serial stage
order on every rank.  The thread executor is refused with a mesh: the
decode stage injects whatever packets the prefill thread has queued when
it looks, which differs from rank to rank, so the ranks' replicated
schedulers would diverge and their collectives would stop pairing up.
"""

from __future__ import annotations

__all__ = ["DisaggServeEngine"]

import threading
from collections import deque

from repro_torch.core.runtime import make_executor, run_stages
from repro_torch.serve import quant as QZ
from repro_torch.serve.engine import ServeEngine

# engine kwargs that only make sense on the decoder (speculation happens at
# decode; a prefill-only engine refuses them at construction)
_DECODE_ONLY = ("spec_decode", "spec_k", "spec_temperature")


class DisaggServeEngine:
    """Prefiller + decoder pair behind the monolithic engine's interface.

    ``submit`` / ``tick`` / ``run_until_drained`` / ``finished`` mirror
    :class:`~repro_torch.serve.engine.ServeEngine`, so the traffic harness
    and the launcher drive either engine unchanged.

    Args:
      executor: ``"serial"`` (default — a fixed stage order) or
        ``"thread"`` or an executor instance; drives the two role stages
        each tick through ``run_stages``.
      prefill_slots / prefill_pages: capacity of the prefiller (defaults:
        the decoder's ``max_slots`` / ``num_pages``).  Remaining kwargs are
        shared engine configuration; ``spec_decode`` (and friends) apply to
        the decoder only.  Both engines serve the same ``params`` tensors;
        with ``weight_quant="int8"`` the tree is quantized once, before
        either engine is built.
    """

    def __init__(self, model, params, *, executor="serial",
                 max_slots: int = 8, num_pages=None,
                 prefill_slots=None, prefill_pages=None, **kw):
        if kw.get("weight_quant") == "int8":
            params = QZ.quantize_params(params)
        if kw.get("mesh") is not None and executor != "serial":
            raise ValueError(
                f"executor={executor!r} with a mesh: the decode stage "
                "injects whatever the prefill thread has queued when it "
                "looks, which differs rank to rank, so the replicated "
                "schedulers would diverge and the ranks' collectives stop "
                "pairing up; use executor='serial' under a mesh")
        self.executor = make_executor(executor)
        decode_kw = dict(kw)
        prefill_kw = {k: v for k, v in kw.items() if k not in _DECODE_ONLY}
        self.prefiller = ServeEngine(
            model, params, prefill_only=True,
            max_slots=prefill_slots or max_slots,
            num_pages=prefill_pages or num_pages, **prefill_kw)
        self.decoder = ServeEngine(
            model, params, max_slots=max_slots, num_pages=num_pages,
            **decode_kw)
        # packets in flight between the roles; the lock covers the deque
        # and the prefiller's handoffs list when stages run on farm threads
        self._pending: deque = deque()
        self._delivered: list = []      # injected this tick, not released
        self._lock = threading.Lock()

    # -- the monolithic engine's interface -----------------------------------

    def submit(self, prompt, **kwargs) -> int:
        """Enqueue on the prefill role (same signature as ServeEngine)."""
        return self.prefiller.submit(prompt, **kwargs)

    @property
    def model(self):
        """The model both roles serve."""
        return self.decoder.model

    @property
    def device(self):
        """The device both roles serve on."""
        return self.decoder.device

    @property
    def mesh(self):
        """The serving mesh both roles shard over (None: one device)."""
        return self.decoder.mesh

    @property
    def finished(self) -> list:
        """Retired requests from both roles: the prefiller keeps errored and
        instantly finished requests (EOS or budget at the first token), the
        decoder everything that went through a handoff."""
        return self.prefiller.finished + self.decoder.finished

    @property
    def stats(self) -> dict:
        """Per-role stats plus the count of in-flight KV handoffs."""
        return {"prefill": self.prefiller.stats, "decode": self.decoder.stats,
                "pending_handoffs": len(self._pending)}

    def has_work(self) -> bool:
        """True while either role or the handoff queue holds work."""
        return (self.prefiller.sched.has_work()
                or self.decoder.sched.has_work()
                or bool(self._pending))

    # -- role stages ----------------------------------------------------------

    def _prefill_stage(self) -> bool:
        busy = self.prefiller.tick()
        with self._lock:
            while self.prefiller.handoffs:
                self._pending.append(self.prefiller.handoffs.pop(0))
        return busy

    def _decode_stage(self) -> bool:
        # drain pending packets FIFO; stop at the first that doesn't fit so
        # delivery order (and therefore decoder admission order) is stable
        while True:
            with self._lock:
                packet = self._pending[0] if self._pending else None
            if packet is None:
                break
            if not self.decoder.inject_prefilled(packet):
                break                   # no slot/pages yet: retry next tick
            with self._lock:
                self._pending.popleft()
            self._delivered.append(packet)  # released by tick (docstring)
        return self.decoder.tick()

    def tick(self) -> bool:
        """One overlapped prefill+decode step; True if anything ran."""
        try:
            busy = run_stages(self.executor,
                              (self._prefill_stage, self._decode_stage))
        finally:
            # both stages have returned: the prefiller's pool is ours
            for packet in self._delivered:
                packet.release()        # idempotent: drops in-flight refs
            self._delivered.clear()
        return bool(busy) or bool(self._pending)

    def run_until_drained(self, max_ticks: int = 10_000):
        """Tick until both roles idle; returns the finished requests."""
        for _ in range(max_ticks):
            busy = self.tick()
            if not busy and not self.has_work():
                break
        return self.finished

    # -- lifecycle -----------------------------------------------------------

    def close(self):
        """Shut down both engines and the stage executor."""
        self.prefiller.close()
        self.decoder.close()
        shutdown = getattr(self.executor, "shutdown", None)
        if shutdown is not None:
            shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
