"""The paper's function-centric layer, as far as the serving stack uses it:
the host-level master/worker thread farm (:mod:`repro_torch.core.runtime`)
with its ±1 partition (:mod:`repro_torch.core.partition`) and its
timing-proportional rebalancing (:mod:`repro_torch.core.load_balance`)."""
