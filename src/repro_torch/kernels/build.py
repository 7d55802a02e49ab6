"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

The sources compile with ``nvcc``, one process per source, all started
together, and link into one shared library with a plain C interface,
loaded through ``ctypes``.  The build runs at the first CUDA
launch, never at import, into ``build/`` at the repository root, under a
name keyed by a hash of the sources: an edited source builds anew, an
unchanged one loads the library already there.  A failed build, and a
launch that a C entry point reports as failed, raise :class:`KernelError`
(a ``RuntimeError``), so a caller that must not swallow a kernel's failure
(the speculative drafter's caller) can tell it from any other error.
ptxas reports each kernel's registers, spills and shared memory
(``-Xptxas -v``) into a ``.log`` file beside the library
(:func:`build_log`).
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
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_vp, _i, _i64, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# every C entry point that launches returns its cudaError_t (0 = launched)
_SIGNATURES = {
    # x, scale, out, rows, d, eps, x_dtype, scale_dtype, stream
    "rmsnorm_launch": [_vp, _vp, _vp, _i64, _i, _f, _i, _i, _vp],
    # x, delta, scale, s (x + delta; null: not stored), out, rows, d, eps,
    # x_dtype, scale_dtype, stream
    "add_rmsnorm_launch": [_vp] * 5 + [_i64, _i, _f, _i, _i, _vp],
    # y (float32), z, scale, out, rows, d, eps, z_dtype, scale_dtype, stream
    "gated_rmsnorm_launch": [_vp] * 4 + [_i64, _i, _f, _i, _i, _vp],
    # q, k_pages, v_pages, k_scale, v_scale (null unless int8 pages),
    # tables, lengths, out, part_acc, part_ml (null unless split), B, W,
    # Hq, Hkv, D, page_size, P, n_split, scale, q dtype, page dtype, stream
    "paged_attention_mq_launch": [_vp] * 10 + [_i] * 8 + [_f, _i, _i, _vp],
    # q, k, v, out, lse (null: not written), B, Sq, Sk, Hq, Hkv, D, q/k/v
    # (batch, seq, head) strides, causal, window, q_off, scale, dtype, route
    # (1: tensor cores), stream
    "flash_attention_launch": [_vp] * 5 + [_i] * 6 + [_i64] * 9
                              + [_i, _i, _i, _f, _i, _i, _vp],
    # r, k, v, w, u, state0 (null: zeros), y, out_state, B, S, H, K, V,
    # r/k/v dtype, stream
    "rwkv6_scan_launch": [_vp] * 8 + [_i] * 6 + [_vp],
    # r, k, v, w, u, state0 (null: zeros), y, out_state, workspace, decays,
    # B, S, H, r/k/v dtype, stream
    "rwkv6_scan_tc_launch": [_vp] * 10 + [_i] * 4 + [_vp],
    # xdt, la, Bm, Cm, state0 (null: zeros), y, out_state, B, S, H, N, P,
    # Bm/Cm dtype, stream
    "ssd_scan_launch": [_vp] * 7 + [_i] * 6 + [_vp],
    # xdt, la, Bm, Cm (bf16), state0 (null: zeros), y, out_state, workspace,
    # decays, B, S, H, stream
    "ssd_scan_tc_launch": [_vp] * 9 + [_i] * 3 + [_vp],
    # v (the norm's input), dy, ds (null: none), scale, dv, workspace,
    # dscale, rows, d, eps, x_dtype, scale_dtype, stream
    "rmsnorm_bwd_launch": [_vp] * 7 + [_i64, _i, _f, _i, _i, _vp],
    # q, k, v, o, dout, dq, dk, dv, lse, delta, B, Sq, Sk, q_off, Hq, Hkv,
    # D, causal, window, scale, dtype, route (1: tensor cores), stream
    "flash_attention_bwd_launch": [_vp] * 10 + [_i] * 9 + [_f, _i, _i, _vp],
    # r, k, v, w, u, state0 (null: zeros), dy, dsT (null: zero), dr, dk,
    # dv, dw, du_part, du, ds0 (null: not wanted), workspace, B, S, H, K, V,
    # r/k/v dtype, stream
    "rwkv6_scan_bwd_launch": [_vp] * 16 + [_i] * 6 + [_vp],
    # xdt, la, Bm, Cm, state0 (null: zeros), dy, dsT (null: zero), dxdt,
    # dla, dB, dC, ds0 (null: not wanted), dB and dC partials, workspace,
    # B, S, H, N, P, Bm/Cm dtype, stream
    "ssd_scan_bwd_launch": [_vp] * 15 + [_i] * 6 + [_vp],
    # the same on the tensor-core route (K = V = 64): du_part a chunk,
    # workspace the chunks' states, gradients and decays; B, S, H, r/k/v
    # dtype, stream
    "rwkv6_scan_bwd_tc_launch": [_vp] * 16 + [_i] * 4 + [_vp],
    # the same on the tensor-core route (N = P = 64, bf16 Bm/Cm): dB and
    # dC partials a group of heads, workspace the chunks' states,
    # gradients and decays; B, S, H, stream
    "ssd_scan_bwd_tc_launch": [_vp] * 15 + [_i] * 3 + [_vp],
    # y, z, dout, scale, dy, dz, workspace, dscale, rows, d, eps, z dtype,
    # scale dtype, stream
    "gated_rmsnorm_bwd_launch": [_vp] * 8 + [_i64, _i, _f, _i, _i, _vp],
    # the tensor-core routes' dynamic shared memory a launch (bytes), and
    # the norm backward's blocks for (rows, d, dtype) (not launches: they
    # return the size, not a cudaError_t)
    "rwkv6_scan_tc_smem": [_i],
    "ssd_scan_tc_smem": [_i],
    "rmsnorm_bwd_blocks": [_i64, _i, _i],
}


class KernelError(RuntimeError):
    """A CUDA kernel failed to build, load or launch."""


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
    raise KernelError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def _run(cmds: list[list[str]]) -> str:
    """Run the commands concurrently; their joined output, or a raise
    naming every one that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [f"nvcc failed ({p.returncode}): {' '.join(c)}\n{out}"
              for c, p, out in zip(cmds, procs, outs) if p.returncode != 0]
    if failed:
        raise KernelError("\n".join(failed))
    return "".join(outs)


def _build(target: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cu = [p for p in sources() if p.suffix == ".cu"]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(pathlib.Path(tmp) / f"{p.stem}.o") for p in cu]
        log = _run([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(p),
                     "-o", o] for p, o in zip(cu, objs)])
        lib = str(pathlib.Path(tmp) / "lib.so")
        log += _run([[nvcc, "-shared", "-o", lib, *objs]])
        target.with_suffix(".log").write_text(log)
        os.replace(lib, target)  # atomic: a concurrent loader sees old or new


def _target() -> pathlib.Path:
    """The library's path, named by a hash of the sources and flags."""
    digest = hashlib.sha256()
    for p in sources():
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librepro_torch_{digest.hexdigest()[:16]}.so"


def build_log() -> str:
    """What nvcc and ptxas printed when the current library was built."""
    log = _target().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    with _lock:
        if _lib is None:
            target = _target()
            if not target.exists():
                _build(target)
            try:
                lib = ctypes.CDLL(str(target))
            except OSError as e:
                raise KernelError(f"cannot load {target}: {e}") from e
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
        raise KernelError(f"{what}: CUDA error {err} ({msg}) at launch")
