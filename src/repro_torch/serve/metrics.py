"""Serving metrics from engine-emitted event records: a copy of
``repro.serve.metrics`` (plain Python; the port imports nothing of the
reference package).

Every number here is a pure function of the event log the traffic harness
records (``submit`` / ``tokens`` / ``done`` events with timestamps), so
under the virtual clock the whole report is deterministic: same seed, same
engine configuration → bit-identical percentiles, which is what lets CI
gate p99 TTFT and goodput without noise allowances for load generation.

Definitions (times are in the harness clock's units — engine ticks for the
virtual clock, seconds for the wall clock):

* **TTFT** — time to first token: first ``tokens`` event minus ``submit``.
* **ITL** — inter-token latency: gaps between a request's consecutive
  token-emission times, pooled across requests before taking percentiles
  (a request emitting several tokens in one tick — speculation, chunk
  completion — contributes zero-gaps, as it should: they arrived together).
* **e2e** — end-to-end latency: ``done`` minus ``submit``.
* **Percentiles** — nearest-rank (``sorted[ceil(q/100 * n) - 1]``): no
  interpolation, so reports are exactly reproducible and robust to the
  tiny sample counts of smoke runs.
* **Goodput** — tokens/s produced by SLO-compliant requests only, over the
  span from first submit to last completion.  A request is compliant iff
  every threshold present in the ``slo`` dict holds: ``ttft``, ``e2e``,
  and ``itl`` (its *worst* gap).  Errored requests are never compliant.
"""

from __future__ import annotations

__all__ = ["compute_report", "nearest_rank", "percentiles"]

import math
from typing import Optional


def nearest_rank(xs, q: float) -> Optional[float]:
    """Nearest-rank percentile of ``xs`` (None for an empty sample)."""
    if not xs:
        return None
    s = sorted(xs)
    k = max(1, math.ceil(q / 100.0 * len(s)))
    return float(s[k - 1])


def percentiles(xs) -> dict:
    """p50/p95/p99 (nearest-rank) plus the sample count."""
    return {"p50": nearest_rank(xs, 50), "p95": nearest_rank(xs, 95),
            "p99": nearest_rank(xs, 99), "n": len(xs)}


def _per_request(events) -> dict:
    """Fold the flat event log into per-rid lifecycle records."""
    per: dict = {}
    for e in events:
        r = per.setdefault(e["rid"], {"submit": None, "tok_times": [],
                                      "done": None, "error": False})
        if e["kind"] == "submit":
            r["submit"] = e["t"]
        elif e["kind"] == "tokens":
            r["tok_times"].extend([e["t"]] * int(e["n"]))
        elif e["kind"] == "done":
            r["done"] = e["t"]
            r["error"] = bool(e.get("error", False))
    return per


def compute_report(events, *, slo: Optional[dict] = None) -> dict:
    """The metric report for one harness run.  ``slo`` may hold any of
    ``{"ttft": ..., "e2e": ..., "itl": ...}`` thresholds in clock units;
    with no SLO every non-errored request counts as compliant, so goodput
    equals throughput."""
    per = _per_request(events)
    slo = dict(slo or {})
    inf = float("inf")
    ttft, itl, e2e = [], [], []
    total_tokens = good_tokens = good_requests = measured = errors = 0
    t0 = min((r["submit"] for r in per.values()
              if r["submit"] is not None), default=0.0)
    t1 = t0
    for rid in sorted(per):
        r = per[rid]
        if r["done"] is not None:
            t1 = max(t1, r["done"])
        if r["error"] or r["submit"] is None or not r["tok_times"]:
            errors += r["error"]
            continue
        measured += 1
        tt = r["tok_times"][0] - r["submit"]
        gaps = [b - a for a, b in zip(r["tok_times"], r["tok_times"][1:])]
        end = r["done"] if r["done"] is not None else r["tok_times"][-1]
        t1 = max(t1, end)
        ee = end - r["submit"]
        ttft.append(tt)
        itl.extend(gaps)
        e2e.append(ee)
        total_tokens += len(r["tok_times"])
        ok = (tt <= slo.get("ttft", inf) and ee <= slo.get("e2e", inf)
              and (max(gaps) if gaps else 0.0) <= slo.get("itl", inf))
        if ok:
            good_tokens += len(r["tok_times"])
            good_requests += 1
    span = max(t1 - t0, 1e-9)
    return {
        "n_requests": len(per),
        "n_measured": measured,
        "n_errors": errors,
        "tokens": total_tokens,
        "span": span,
        "tok_per_s": total_tokens / span,
        "ttft": percentiles(ttft),
        "itl": percentiles(itl),
        "e2e": percentiles(e2e),
        "slo": slo,
        "goodput": {
            "tok_per_s": good_tokens / span,
            "req_per_s": good_requests / span,
            "slo_attainment": good_requests / measured if measured else 0.0,
        },
    }
