"""The serving stack of the port: paged-KV continuous batching on one card.

* :mod:`repro_torch.serve.pages` — refcounted page pool, radix prefix cache,
  in-place scatter/gather/copy device ops.
* :mod:`repro_torch.serve.sampling` — greedy token selection.
* :mod:`repro_torch.serve.scheduler` — admission, chunked prefill planning,
  copy-on-write and preemption (host-side numpy, shared with the reference
  line for line).
* :mod:`repro_torch.serve.engine` — the tick loop driving a model's paged
  prefill and decode functions.
"""
