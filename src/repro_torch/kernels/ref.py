"""The plain PyTorch versions of the port's kernels, under the reference
oracle names (``repro.kernels.ref``), so tests can name both side by side;
RMSNorm's fused variants (``add_rmsnorm``, ``gated_rmsnorm``) have no
reference oracle and keep the ops' names.  Each lives beside its kernel's
launcher; this module only re-exports."""
from repro_torch.kernels.flash_attention import \
    flash_attention_plain as flash_attention
from repro_torch.kernels.paged_attention import \
    paged_attention_mq_plain as paged_attention_mq
from repro_torch.kernels.rmsnorm import (
    add_rmsnorm_plain as add_rmsnorm, gated_rmsnorm_plain as gated_rmsnorm,
    rmsnorm_plain as rmsnorm)
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_plain as rwkv6_scan
from repro_torch.kernels.ssd_scan import ssd_scan_plain as ssd_scan

__all__ = ["add_rmsnorm", "flash_attention", "gated_rmsnorm",
           "paged_attention_mq", "rmsnorm", "rwkv6_scan", "ssd_scan"]
