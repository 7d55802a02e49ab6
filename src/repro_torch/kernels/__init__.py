"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each kernel has a launcher module (``rmsnorm.py``, ``paged_attention.py``,
``flash_attention.py``, ``rwkv6_scan.py``, ``ssd_scan.py``: the ctypes
launch plus the plain version beside it), a counted public wrapper in
``ops.py`` and its plain version re-exported from ``ref.py``.
``build.py`` compiles ``csrc/*.cu`` at the first CUDA launch.
"""
