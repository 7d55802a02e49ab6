"""Atomic checkpoints with latest-valid discovery, in the reference's
on-disk layout, so a checkpoint written by either package restores into
the other.

Layout (one directory per step)::

    <dir>/step_00000420/
        manifest.json         {"step": 420, "leaves": {name: {file, shape,
                                                              dtype, crc}}}
        <name>.npy            one array per leaf
        COMMIT                written last; its presence marks validity

A leaf's name is the reference's: ``jax.tree_util.keystr`` of its dict
path (``['params']['blocks']['attn']['wq']``) with every character outside
``[A-Za-z0-9_.-]`` replaced by ``_`` and the ends stripped of ``_``.  The
CRC is ``zlib.crc32`` of the array's bytes.  Everything is written into
``step_X.tmp`` and renamed once the COMMIT marker is in, so a crash
mid-save leaves a ``.tmp`` that discovery ignores; restore checks every
leaf's CRC and raises ``ValueError`` on a missing or corrupted leaf (the
callers fall back to an older checkpoint:
:func:`repro_torch.train.fault.restore_latest_valid`).

Arrays are saved whole, in the logical layout, whatever mesh wrote them,
so a checkpoint restores onto another mesh or onto one device (the
elastic path, :func:`repro_torch.train.fault.reshard_state`).  On a mesh
(``shardings``: :func:`repro_torch.train.state.state_shardings`) every
rank gathers every leaf, rank 0 writes, and the ranks meet before any
returns; on restore every rank reads each leaf and cuts its own shard.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.mesh.grad_comm import gather
from repro_torch.models.module import shard_leaf

_STEP_RE = re.compile(r"^step_(\d{8})$")


def _leaf_name(path: tuple) -> str:
    s = "".join(f"[{k!r}]" for k in path)
    return re.sub(r"[^A-Za-z0-9_.-]", "_", s).strip("_") or "root"


def _leaves(tree, path=()):
    """(path, leaf) pairs of a nested dict, keys in sorted order (the
    reference's flattening order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # the reference's bf16 arrays are ml_dtypes'
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def checkpoint_steps(ckpt_dir: str) -> list[int]:
    """Committed steps, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "COMMIT")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_checkpoint(ckpt_dir: str) -> Optional[int]:
    """The newest committed step, or None."""
    steps = checkpoint_steps(ckpt_dir)
    return steps[-1] if steps else None


def _gathered(state, shardings):
    """(path, whole leaf) of a sharded state, one leaf gathered at a time
    (a collective of every rank of the mesh)."""
    sh = dict(_leaves(shardings))
    for path, leaf in _leaves(state):
        with torch.no_grad():
            yield path, gather(leaf, sh[path].spec, sh[path].mesh)


def save_checkpoint(ckpt_dir: str, step: int, state: Any, *,
                    keep: int = 3, shardings: Any = None) -> str:
    """Write ``state`` (a nested dict of tensors) atomically; prune to the
    newest ``keep`` checkpoints.  Returns the step's directory.  With
    ``shardings`` (the state's layout on a mesh; every rank calls) each
    leaf is gathered whole on every rank, one at a time, and rank 0 writes
    it; the ranks return together, once the checkpoint is committed."""
    if shardings is None:
        return _write(ckpt_dir, step, _leaves(state), keep)
    mesh = next(sh for _, sh in _leaves(shardings)).mesh
    leaves = _gathered(state, shardings)
    if mesh.world.rank() == 0:
        final = _write(ckpt_dir, step, leaves, keep)
    else:
        final = os.path.join(ckpt_dir, f"step_{step:08d}")
        for _ in leaves:
            pass
    dev = next(t for _, t in _leaves(state)).device
    mesh.world.all_reduce_sum(torch.zeros(1, device=dev))    # a barrier
    return final


def _write(ckpt_dir: str, step: int, leaves, keep: int) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {}
    for path, leaf in leaves:
        name = _leaf_name(path)
        arr = _to_numpy(leaf)
        fn = name + ".npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest[name] = {"file": fn, "shape": list(arr.shape),
                          "dtype": str(arr.dtype),
                          "crc": zlib.crc32(arr.tobytes())}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "leaves": manifest}, f, indent=1)
    with open(os.path.join(tmp, "COMMIT"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    for old in checkpoint_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{old:08d}"),
                      ignore_errors=True)
    return final


def restore_checkpoint(ckpt_dir: str, state_like: Any, *,
                       step: Optional[int] = None,
                       shardings: Any = None) -> tuple[Any, int]:
    """Restore into the structure of ``state_like``: each leaf on its
    like's device, requiring a gradient where its like does; with
    ``shardings`` (``state_like``'s layout on a mesh, which may differ from
    the writer's) each leaf is this rank's shard of the saved array.
    Raises ``ValueError`` on missing or corrupted data.  Returns
    ``(state, step)``."""
    sh = None if shardings is None else dict(_leaves(shardings))
    if step is None:
        step = latest_checkpoint(ckpt_dir)
        if step is None:
            raise ValueError(f"no committed checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)["leaves"]

    def restore(tree, path=()):
        if isinstance(tree, dict):
            return {k: restore(v, path + (k,)) for k, v in tree.items()}
        name = _leaf_name(path)
        if name not in manifest:
            raise ValueError(f"checkpoint {d} missing leaf {name}")
        meta = manifest[name]
        arr = np.load(os.path.join(d, meta["file"]))
        if zlib.crc32(arr.tobytes()) != meta["crc"]:
            raise ValueError(f"checkpoint {d} leaf {name} corrupted (crc)")
        out = _from_numpy(arr)
        if sh is not None:
            out = shard_leaf(out, sh[path].spec, sh[path].mesh)
        if tuple(out.shape) != tuple(tree.shape):
            raise ValueError(f"leaf {name}: shape {tuple(out.shape)} != "
                             f"expected {tuple(tree.shape)}")
        out = out.to(tree.device)
        return out.requires_grad_(True) if tree.requires_grad else out

    return restore(state_like), step
