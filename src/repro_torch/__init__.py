"""PyTorch and CUDA port of the serving stack and of the paper's
function-centric layer (:mod:`repro_torch.core`, :mod:`repro_torch.apps`),
for one NVIDIA Hopper card.

The package mirrors ``repro`` module for module where a counterpart exists
(``repro_torch/<pkg>/<mod>.py`` <-> ``repro/<pkg>/<mod>.py``) and imports
nothing of it.  Models are plain functions over dict-of-tensor params; the
paged-attention and RMSNorm hot spots are hand-written CUDA kernels
(:mod:`repro_torch.kernels`), built from ``csrc/`` at their first launch.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
