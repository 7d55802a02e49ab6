"""Traffic harness: seeded arrival processes driving a serving engine.

A copy of ``repro.serve.traffic`` over the port's engine; the arrival
processes, workloads, clocks and traces are the reference's line for line,
so one seed gives both packages the same schedule.  This is the
load-generation half of the measurement story (the metric half is
:mod:`repro_torch.serve.metrics`):

* :func:`make_workload` — a deterministic, seeded workload: Poisson or
  bursty arrivals, shared-prefix chat sessions (``n_sessions`` system
  prompts drawn once, requests appending their own tails — the pattern the
  prefix cache exists for), and a mixed prompt-length distribution
  (weighted uniform bands, defaulting to mostly-short-some-long).  Its
  multimodal band (``encoder=``) builds the reference's workloads, but the
  port's engine takes no encoder input yet: :class:`TrafficHarness`
  refuses such a request (ROADMAP A10).
* :class:`TrafficHarness` — drives any engine with the monolithic
  interface (``submit`` / ``tick`` / per-request ``output`` + ``done_at``)
  and emits a flat event log — ``submit`` at the request's *arrival* time
  (so TTFT includes queueing delay), ``tokens`` whenever a tracked
  request's output grew during a tick, ``done`` on retirement — which
  :func:`repro_torch.serve.metrics.compute_report` folds into the report.
* clocks — the :class:`VirtualClock` advances one time unit per engine
  tick and fast-forwards idle gaps, making the entire run (schedule,
  event log, report) a deterministic function of the seed: the property
  CI gates depend on.  The :class:`WallClock` measures real seconds for
  on-hardware numbers; arrivals become offsets from the run start.
* traces — :func:`record_trace` / :func:`workload_from_trace` serialize a
  run (workload + events + token streams) to a JSON-safe dict and rebuild
  the workload from it, so a recorded run replays bit-identically under
  the virtual clock.
"""

from __future__ import annotations

__all__ = ["DEFAULT_LEN_MIX", "TrafficHarness", "TrafficRequest",
           "VirtualClock", "WallClock", "bursty_arrivals",
           "make_workload", "poisson_arrivals", "record_trace",
           "run_traffic", "workload_from_trace"]

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.serve import metrics as MT

# mostly short prompts with a long tail — (weight, lo, hi) inclusive bands
DEFAULT_LEN_MIX = ((3.0, 4, 24), (1.0, 32, 72))


@dataclasses.dataclass
class TrafficRequest:
    """One generated request: arrival time plus everything ``submit`` needs."""
    arrival: float
    prompt: np.ndarray
    max_new_tokens: int = 16
    session: int = -1               # -1: no shared prefix
    seed: Optional[int] = None      # per-request sampling seed (None: greedy)
    encoder_input: Optional[np.ndarray] = None
    #                                 (n, d_model) float32 encoder payload
    #                                 (image-patch embeds / audio frames);
    #                                 None keeps the request text-only

    def to_dict(self) -> dict:
        """JSON-safe dict; float32 payloads survive the round trip exactly."""
        d = {"arrival": float(self.arrival),
             "prompt": [int(t) for t in self.prompt],
             "max_new_tokens": int(self.max_new_tokens),
             "session": int(self.session),
             "seed": None if self.seed is None else int(self.seed)}
        if self.encoder_input is not None:
            # float32 -> Python float (double) -> JSON -> float32 is exact
            # in both directions, so a replayed trace carries bit-identical
            # payloads (and the prefix cache re-keys identically)
            d["encoder_input"] = [
                [float(x) for x in row]
                for row in np.asarray(self.encoder_input, np.float32)]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TrafficRequest":
        """Inverse of :meth:`to_dict`."""
        enc = d.get("encoder_input")
        return cls(arrival=float(d["arrival"]),
                   prompt=np.asarray(d["prompt"], np.int32),
                   max_new_tokens=int(d["max_new_tokens"]),
                   session=int(d.get("session", -1)),
                   seed=d.get("seed"),
                   encoder_input=None if enc is None
                   else np.asarray(enc, np.float32))


# -- arrival processes -------------------------------------------------------

def poisson_arrivals(n: int, rate: float, rng) -> np.ndarray:
    """Cumulative exponential inter-arrivals: the memoryless process every
    open-loop serving benchmark assumes.  ``rate`` is requests per time
    unit (ticks for the virtual clock)."""
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def bursty_arrivals(n: int, rate: float, rng, *, burst: int = 4) -> np.ndarray:
    """Same long-run rate as Poisson, but requests arrive in bursts of
    ``burst`` at Poisson-distributed burst starts — the thundering-herd
    shape that stresses admission and preemption."""
    starts = np.cumsum(rng.exponential(burst / rate,
                                       size=-(-n // burst)))
    return np.repeat(starts, burst)[:n]


def _mixed_lengths(n: int, rng, len_mix) -> np.ndarray:
    w = np.asarray([m[0] for m in len_mix], np.float64)
    comp = rng.choice(len(len_mix), size=n, p=w / w.sum())
    return np.asarray([int(rng.integers(len_mix[c][1], len_mix[c][2] + 1))
                       for c in comp], np.int64)


def make_workload(*, kind: str = "poisson", n_requests: int, rate: float,
                  vocab: int, seed: int = 0, max_new_tokens: int = 16,
                  shared_prefix_len: int = 16, n_sessions: int = 4,
                  len_mix=DEFAULT_LEN_MIX, burst: int = 4,
                  seeded_sampling: bool = False,
                  encoder: Optional[str] = None,
                  encoder_shape: Optional[tuple] = None,
                  encoder_frac: float = 1.0,
                  n_encoder_inputs: int = 4) -> list[TrafficRequest]:
    """A fully deterministic workload: every random draw comes from one
    ``np.random.default_rng(seed)`` in a fixed order, so the same
    arguments always produce the identical request schedule.

    ``encoder`` opens the multimodal band: ``"image"`` or ``"audio"``
    attaches an ``(n, d_model)`` float32 payload of shape
    ``encoder_shape`` to a fraction ``encoder_frac`` of requests, drawn
    from a pool of ``n_encoder_inputs`` distinct payloads.  A session-
    bound request always reuses its session's payload — the repeated-image
    chat pattern VLM prefix caching exists for.  ``encoder=None`` (the
    default) makes NO extra rng draws, so every pre-existing argument
    combination keeps its exact request schedule."""
    rng = np.random.default_rng(seed)
    if kind == "poisson":
        arrivals = poisson_arrivals(n_requests, rate, rng)
    elif kind == "bursty":
        arrivals = bursty_arrivals(n_requests, rate, rng, burst=burst)
    else:
        raise ValueError(
            f"unknown arrival kind {kind!r}; want 'poisson' or 'bursty' "
            "(replay a recorded trace via workload_from_trace)")
    prefixes = []
    if shared_prefix_len > 0 and n_sessions > 0:
        prefixes = [rng.integers(0, vocab, size=shared_prefix_len)
                    for _ in range(n_sessions)]
    lengths = _mixed_lengths(n_requests, rng, len_mix)
    enc_pool = []
    if encoder is not None:
        if encoder not in ("image", "audio"):
            raise ValueError(
                f"unknown encoder kind {encoder!r}; want 'image' or "
                "'audio'")
        if encoder_shape is None or len(encoder_shape) != 2:
            raise ValueError(
                "encoder workloads need encoder_shape=(n, d_model) — "
                "n_image_tokens/n_audio_frames by the model's d_model")
        enc_pool = [rng.standard_normal(encoder_shape).astype(np.float32)
                    for _ in range(max(1, n_encoder_inputs))]
    out = []
    for i in range(n_requests):
        sess = int(rng.integers(0, n_sessions)) if prefixes else -1
        tail = rng.integers(0, vocab, size=int(lengths[i]))
        prompt = (np.concatenate([prefixes[sess], tail]) if sess >= 0
                  else tail).astype(np.int32)
        enc = None
        if enc_pool:
            carry = bool(rng.random() < encoder_frac)
            idx = (sess % len(enc_pool)) if sess >= 0 \
                else int(rng.integers(0, len(enc_pool)))
            if carry:
                enc = enc_pool[idx]
        out.append(TrafficRequest(
            arrival=float(arrivals[i]), prompt=prompt,
            max_new_tokens=max_new_tokens, session=sess,
            seed=i if seeded_sampling else None,
            encoder_input=enc))
    return out


# -- clocks ------------------------------------------------------------------

class VirtualClock:
    """Deterministic time: one engine tick = ``tick_time`` units; idle gaps
    fast-forward to the next arrival instead of spinning."""

    def __init__(self, tick_time: float = 1.0):
        self.now = 0.0
        self.tick_time = tick_time

    def after_tick(self) -> float:
        """Advance one tick; returns the new time."""
        self.now += self.tick_time
        return self.now

    def fast_forward(self, t: float) -> None:
        """Jump ahead to ``t`` (never backwards)."""
        self.now = max(self.now, t)


class WallClock:
    """Real seconds since the run started; arrivals are offsets from it."""

    def __init__(self):
        self._t0 = time.perf_counter()

    @property
    def now(self) -> float:
        """Seconds since construction."""
        return time.perf_counter() - self._t0

    def after_tick(self) -> float:
        """Wall time advances on its own; just report it."""
        return self.now

    def fast_forward(self, t: float) -> None:
        """Sleep (briefly) towards ``t``; the caller re-checks in a loop."""
        dt = t - self.now
        if dt > 0:
            time.sleep(min(dt, 0.05))       # re-checked by the caller's loop


# -- the harness -------------------------------------------------------------

class TrafficHarness:
    """Open-loop load generator: submit requests when their arrival time comes
    (never earlier — queueing delay is part of the measurement), tick the
    engine, and record the event log."""

    def __init__(self, engine, *, clock: str = "virtual",
                 tick_time: float = 1.0):
        self.engine = engine
        self.clock_kind = clock
        if clock == "virtual":
            self.clock = VirtualClock(tick_time)
        elif clock == "wall":
            self.clock = WallClock()
        else:
            raise ValueError(f"unknown clock {clock!r}; want 'virtual' or "
                             "'wall'")
        self.events: list[dict] = []

    def _submit_queue(self) -> list:
        # the queue new submissions land on
        return self.engine.sched.queue

    def _engine_busy(self) -> bool:
        return self.engine.sched.has_work()

    def run(self, workload, *, max_ticks: int = 100_000) -> list[dict]:
        """Drive the engine through the workload; returns the event log."""
        work = sorted(workload, key=lambda r: r.arrival)
        events = self.events = []
        track: dict[int, dict] = {}
        i = 0
        for _ in range(max_ticks):
            if i >= len(work) and all(t["done"] for t in track.values()):
                break
            if (i < len(work) and work[i].arrival > self.clock.now
                    and not self._engine_busy()):
                self.clock.fast_forward(work[i].arrival)
            while i < len(work) and work[i].arrival <= self.clock.now:
                tr = work[i]
                if tr.encoder_input is not None:
                    raise NotImplementedError(
                        "a request with encoder_input is not ported yet: "
                        "it comes with the multimodal slice (ROADMAP A10)")
                rid = self.engine.submit(tr.prompt,
                                         max_new_tokens=tr.max_new_tokens,
                                         seed=tr.seed)
                req = self._submit_queue()[-1]
                assert req.rid == rid
                track[rid] = {"req": req, "seen": 0, "done": False}
                ev = {"t": float(tr.arrival), "rid": rid,
                      "kind": "submit",
                      "prompt_len": int(len(tr.prompt)),
                      "session": int(tr.session)}
                events.append(ev)
                i += 1
            self.engine.tick()
            now = self.clock.after_tick()
            for rid, tr in track.items():
                if tr["done"]:
                    continue
                n_new = len(tr["req"].output) - tr["seen"]
                if n_new > 0:
                    events.append({"t": now, "rid": rid, "kind": "tokens",
                                   "n": n_new})
                    tr["seen"] += n_new
                if tr["req"].done_at is not None:
                    tr["done"] = True
                    events.append({"t": now, "rid": rid, "kind": "done",
                                   "error": tr["req"].error is not None})
        return events

    def outputs(self) -> dict:
        """Token stream per rid from the engine's finished list."""
        return {int(r.rid): [int(t) for t in r.output]
                for r in self.engine.finished}


def run_traffic(engine, workload, *, clock: str = "virtual",
                tick_time: float = 1.0, slo: Optional[dict] = None,
                max_ticks: int = 100_000) -> dict:
    """One harness run end to end: events, token streams, metric report."""
    h = TrafficHarness(engine, clock=clock, tick_time=tick_time)
    events = h.run(workload, max_ticks=max_ticks)
    return {"events": events, "outputs": h.outputs(),
            "report": MT.compute_report(events, slo=slo)}


# -- trace record / replay ---------------------------------------------------

def record_trace(workload, events, outputs) -> dict:
    """A JSON-safe record of one run: replaying its workload under the
    virtual clock reproduces ``events`` and ``outputs`` bit-identically."""
    return {"version": 1,
            "workload": [r.to_dict() for r in workload],
            "events": list(events),
            "outputs": {str(rid): [int(t) for t in toks]
                        for rid, toks in outputs.items()}}


def workload_from_trace(trace: dict) -> list[TrafficRequest]:
    """Rebuild the exact workload a :func:`record_trace` dict captured."""
    return [TrafficRequest.from_dict(d) for d in trace["workload"]]
