"""The serving stack of the port: paged-KV continuous batching on one card.

* :mod:`repro_torch.serve.pages` — refcounted page pool, radix prefix cache,
  in-place scatter/gather/copy device ops.
* :mod:`repro_torch.serve.quant` / :mod:`repro_torch.serve.sampling` /
  :mod:`repro_torch.serve.spec` — orthogonal policies: int8 KV pages and
  weights, token sampling (over the threefry keys of
  :mod:`repro_torch.serve.prng`), speculative drafting.
* :mod:`repro_torch.serve.scheduler` — admission, chunked prefill planning,
  copy-on-write and preemption (host-side numpy, shared with the reference
  line for line).
* :mod:`repro_torch.serve.engine` — the tick loop driving a model's paged
  prefill, decode and verify functions, or its dense per-slot ones.
* :mod:`repro_torch.serve.traffic` / :mod:`repro_torch.serve.metrics` —
  seeded open-loop workloads and SLO reporting.
"""
from repro_torch.serve.pages import PagePool, PagedLeafSpec, PrefixCache
from repro_torch.serve.sampling import (greedy, sample_temperature,
                                        sample_top_k, sample_top_p,
                                        spec_rejection_sample,
                                        spec_verify_greedy)
from repro_torch.serve.quant import (Int8KVQuant, dequantize_params,
                                     kv_bytes_per_token, make_kv_quant,
                                     quantize_leaf_specs, quantize_params)
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.spec import (Drafter, NgramDrafter,
                                    TruncatedSelfDrafter, make_drafter)
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.metrics import (compute_report, nearest_rank,
                                       percentiles)
from repro_torch.serve.traffic import (TrafficHarness, TrafficRequest,
                                       bursty_arrivals, make_workload,
                                       poisson_arrivals, record_trace,
                                       run_traffic, workload_from_trace)

__all__ = ["Drafter", "Int8KVQuant", "NgramDrafter", "PagePool",
           "PagedLeafSpec", "PrefixCache", "Request", "Scheduler",
           "ServeEngine", "TrafficHarness", "TrafficRequest",
           "TruncatedSelfDrafter", "bursty_arrivals", "compute_report",
           "dequantize_params", "greedy", "kv_bytes_per_token",
           "make_drafter", "make_kv_quant", "make_workload", "nearest_rank",
           "percentiles", "poisson_arrivals", "quantize_leaf_specs",
           "quantize_params", "record_trace", "run_traffic",
           "sample_temperature", "sample_top_k", "sample_top_p",
           "spec_rejection_sample", "spec_verify_greedy",
           "workload_from_trace"]
