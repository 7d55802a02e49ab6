"""Counter-based random numbers of the port: threefry2x32 keys and draws,
bit for bit those of ``jax.random`` under its default implementation
(``threefry2x32``, ``jax_threefry_partitionable`` on, as jax 0.9.0 sets it).

The engine seeds a request's token ``i`` with ``fold_in(PRNGKey(seed),
i)``, as the reference does, so a seeded stream depends on nothing but the
seed and the logits; a ``torch.Generator`` could not reproduce it.

* A **key** is a ``(2,)`` uint32 numpy array on the host: keys are made,
  split and folded a few times a tick, each a single threefry block, so
  they never touch the device.
* A key may also be an int64 tensor of the same two words on a device
  (``PRNGKey(seed, device=...)``).  :func:`split`, :func:`fold_in` and
  every draw take it and give tensors back, with the same bits, and never
  read it on the host: a stack of such keys goes through
  ``torch.func.vmap``, so the science apps' chains and walkers draw from
  explicit keys where the vmap cannot hide a generator's state.
* A **draw** (:func:`bits`, :func:`uniform`, :func:`normal`,
  :func:`randint`, :func:`categorical`) runs on the device of the tensor it serves (the
  logits' for a categorical, a tensor key's own), one threefry lane per
  element.

torch has no uint32 arithmetic, so the hash runs on int64 values below
2**32, masked after every add and before every logical shift.  The same
code serves numpy int64 arrays (keys) and torch int64 tensors (draws).

In partitionable mode the counters of a draw of ``shape`` are the 64-bit
row-major index of each element, split into a (hi, lo) pair of words, and
a 32-bit draw is the XOR of the two output words; ``split`` hashes the
indices ``0..n-1`` the same way and keeps both words as the new keys;
``fold_in(key, d)`` hashes the one pair ``(0, d)``.
"""
from __future__ import annotations

__all__ = ["PRNGKey", "bits", "categorical", "fold_in", "gumbel", "normal",
           "randint", "split", "threefry2x32", "uniform"]

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_NMANT = 23                                  # float32 mantissa bits
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))       # float32, as jax multiplies


def _rotl(x, d: int):
    """32-bit rotate left of values held in int64 (d <= 29: no overflow)."""
    return ((x << d) & MASK) | (x >> (32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block (20 rounds) of key words ``k1, k2`` (ints,
    or int64 tensors) over the counter words ``x1, x2``: int64 arrays or
    tensors holding uint32 values.  Returns the two output words the same
    way."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def _words(key):
    """A key's two words: ints for a host key, int64 tensors (never read on
    the host) for a tensor key."""
    if isinstance(key, torch.Tensor):
        if key.shape != (2,):
            raise ValueError(f"a key is a (2,) array, got shape "
                             f"{tuple(key.shape)}")
        return key[0], key[1]
    k = np.asarray(key)
    if k.shape != (2,):
        raise ValueError(f"a key is a (2,) uint32 array, got shape {k.shape}")
    return int(k[0]) & MASK, int(k[1]) & MASK


def _key(w1, w2) -> np.ndarray:
    return np.asarray([int(w1), int(w2)], np.uint32)


def PRNGKey(seed: int, device=None):
    """The key of an integer seed: its high and low 32-bit words (a seed
    in 32 bits has a zero high word; a negative one is taken mod 2**32, as
    jax's 32-bit mode converts it).  With ``device``, the two words as an
    int64 tensor there (a tensor key)."""
    seed = int(seed)
    if not -2**31 <= seed < 2**32:
        raise OverflowError(f"seed {seed} does not fit 32 bits")
    if device is not None:
        return torch.tensor([0, seed & MASK], dtype=torch.int64,
                            device=device)
    return _key(0, seed & MASK)


def fold_in(key, data):
    """A new key from ``key`` and a 32-bit integer (an int64 tensor too,
    for a tensor key)."""
    k1, k2 = _words(key)
    if isinstance(key, torch.Tensor):
        d = (data if isinstance(data, torch.Tensor) else torch.full(
            (), int(data), dtype=torch.int64, device=key.device)) & MASK
        y1, y2 = threefry2x32(k1, k2, torch.zeros_like(d), d)
        return torch.stack([y1, y2])
    y1, y2 = threefry2x32(k1, k2, np.int64(0), np.int64(int(data) & MASK))
    return _key(y1, y2)


def split(key, num: int = 2):
    """``num`` new keys from ``key``: a (num, 2) uint32 array, or a (num, 2)
    int64 tensor for a tensor key."""
    k1, k2 = _words(key)
    if isinstance(key, torch.Tensor):
        lo = torch.arange(num, dtype=torch.int64, device=key.device)
        y1, y2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
        return torch.stack([y1, y2], dim=-1)
    lo = np.arange(num, dtype=np.int64)
    y1, y2 = threefry2x32(k1, k2, np.zeros_like(lo), lo)
    return np.stack([y1, y2], axis=-1).astype(np.uint32)


def _device(key, device):
    """Where a draw runs: ``device`` if given, else a tensor key's own
    device, else the CPU."""
    if device is not None:
        return device
    return key.device if isinstance(key, torch.Tensor) else "cpu"


def bits(key, shape=(), *, device=None) -> torch.Tensor:
    """Uniform 32-bit draws of ``shape`` on ``device`` (default: a tensor
    key's device, else the CPU), as int64 values in ``[0, 2**32)``
    (``jax.random.bits``'s uint32 values)."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape, dtype=np.int64))
    if n >= 2**32:          # the counters' high word would be needed
        raise NotImplementedError("draws of 2**32 elements or more")
    k1, k2 = _words(key)
    lo = torch.arange(n, dtype=torch.int64, device=_device(key, device))
    y1, y2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return (y1 ^ y2).reshape(shape)


def uniform(key, shape=(), *, minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """float32 draws in ``[minval, maxval)``: the top 23 bits of each draw
    as the mantissa of a float in [1, 2), minus 1, scaled, shifted and
    clamped below at ``minval``, as ``jax.random.uniform`` computes them.

    XLA contracts ``f * (maxval - minval) + minval`` into one fused
    multiply-add (one rounding).  float64 holds the product of two float32
    values exactly, so the float64 sum rounded to float32 is the fused
    result wherever that sum is exact in float64 too, as it is for ranges
    of moderate exponents ([0, 1), [-2, 3)); for [tiny, 1) the float64 sum
    drops ``tiny`` against any nonzero draw, as the fused one does."""
    device = _device(key, device)
    b = bits(key, shape, device=device)
    # the float in [1, 2) with these 23 mantissa bits, minus 1, is
    # m / 2**23 exactly: no bit cast (torch.func.vmap batches none)
    f = (b >> (32 - _NMANT)).to(torch.float32) * 2.0 ** -_NMANT
    # torch.full, not torch.tensor: no host-to-device copy, so a draw can
    # be captured in a CUDA graph
    lo = torch.full((), minval, dtype=torch.float32, device=device)
    span = torch.full((), maxval, dtype=torch.float32, device=device) - lo
    fused = (f.double() * span.double() + lo.double()).to(torch.float32)
    return torch.maximum(lo, fused)


def randint(key, shape, minval: int, maxval: int, *,
            device=None) -> torch.Tensor:
    """int32 draws in ``[minval, maxval)``, as ``jax.random.randint``
    computes them for int32 (64 random bits an element, from the two keys
    of ``split(key)``, reduced modulo the span in uint32 arithmetic, its
    wrap-arounds included: for a span above 2**16 the multiplier
    ``2**32 mod span`` wraps to 0 there, so only the low word counts).
    ``minval``/``maxval`` are ints in int32's range; ``maxval <= minval``
    gives ``minval``."""
    lo_lim, hi_lim = -2**31, 2**31 - 1
    if not (lo_lim <= minval <= hi_lim and lo_lim <= maxval <= hi_lim):
        raise OverflowError(f"randint: [{minval}, {maxval}) is outside "
                            "int32")
    k = split(key)
    higher = bits(k[0], shape, device=device)
    lower = bits(k[1], shape, device=device)
    span = (maxval - minval) & MASK if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & MASK) % span
    off = ((((higher % span) * mult) & MASK) + lower % span) & MASK
    return (minval + off % span).to(torch.int32)


def normal(key, shape=(), *, device=None) -> torch.Tensor:
    """Standard normal float32 draws, ``sqrt(2) * erfinv(u)`` of a uniform
    ``u`` in ``[nextafter(-1, 0), 1)``, as jax 0.9.0's ``_normal_real``
    computes them; torch's ``erfinv`` and XLA's differ by ulps."""
    u = uniform(key, shape, minval=_NORMAL_LO, maxval=1.0, device=device)
    return _SQRT2 * torch.erfinv(u)


def gumbel(key, shape=(), *, device=None) -> torch.Tensor:
    """Standard Gumbel float32 draws, ``-log(-log(u))`` of a uniform ``u``
    in ``[tiny, 1)`` (jax's default "low" mode), on ``device`` (a tensor
    key's own unless named, as every draw here)."""
    tiny = float(torch.finfo(torch.float32).tiny)
    u = uniform(key, shape, minval=tiny, maxval=1.0, device=device)
    return -torch.log(-torch.log(u))


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """One draw from ``softmax(logits)`` along the last axis of each row:
    the argmax of the logits plus Gumbel noise (first index on ties), on
    the logits' device.  Returns int64 of ``logits.shape[:-1]``."""
    logits = torch.as_tensor(logits)
    g = gumbel(key, logits.shape, device=logits.device).to(logits.dtype)
    return torch.argmax(g + logits, dim=-1)
