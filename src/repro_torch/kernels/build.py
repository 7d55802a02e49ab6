"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

The sources compile with ``nvcc`` into one shared library with a plain C
interface, loaded through ``ctypes``.  The build runs at the first CUDA
launch, never at import, into ``build/`` at the repository root, under a
name keyed by a hash of the sources: an edited source builds anew, an
unchanged one loads the library already there.  A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_vp, _i, _i64, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# every C entry point returns its cudaError_t (0 = launched)
_SIGNATURES = {
    # x, scale, out, rows, d, eps, x_dtype, scale_dtype, stream
    "rmsnorm_launch": [_vp, _vp, _vp, _i64, _i, _f, _i, _i, _vp],
    # q, k_pages, v_pages, tables, lengths, out,
    # B, W, Hq, Hkv, D, page_size, P, scale, dtype, stream
    "paged_attention_mq_launch": [_vp, _vp, _vp, _vp, _vp, _vp,
                                  _i, _i, _i, _i, _i, _i, _i, _f, _i, _vp],
}


def sources() -> list[pathlib.Path]:
    """The CUDA sources the library is built from."""
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def _build(target: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in sources() if p.suffix == ".cu"]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, target)     # atomic: a concurrent loader sees old or new


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    with _lock:
        if _lib is None:
            digest = hashlib.sha256()
            for p in sources():
                digest.update(p.name.encode())
                digest.update(p.read_bytes())
            digest.update(" ".join(NVCC_FLAGS).encode())
            target = BUILD_DIR / f"librepro_torch_{digest.hexdigest()[:16]}.so"
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.kernel_error_string.argtypes = [_i]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")
