"""Optimizer-side numerics of the port.  For now only the symmetric int8
quantizer of :mod:`repro_torch.optim.compress`, which the serving stack's
int8 KV pages and int8 weights use; the gradient all-reduce that is its
other consumer in the reference comes with training (ROADMAP A13)."""
