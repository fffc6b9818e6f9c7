"""JAX's threefry-2x32 random stream on torch tensors.

The reference draws every RANSAC sample with ``jax.random.choice`` from a
raw ``uint32[2]`` key that it splits with ``jax.random.split``
(``ops/ransac.py``, ``slam/system.py``). This module reproduces those
draws bit for bit, so that the port evaluates the same hypotheses:

- ``threefry2x32``: the Threefry-2x32 hash (20 rounds, JAX's rotation
  constants and key schedule);
- ``split``, ``random_bits``, ``uniform``: JAX's counter layout with
  ``jax_threefry_partitionable`` on (the default since JAX 0.5): the
  counters are a 64-bit iota over the output shape, split into high and
  low 32-bit words;
- ``choice`` with replacement and probabilities: ``searchsorted`` of
  ``p_cuml[-1] * (1 - uniform)`` into ``p_cuml``, the cumulative sum taken
  in the order XLA's CPU backend sums it (``xla_cumsum``).

Keys are int64 tensors [2] holding uint32 values, on any device; the
uint32 arithmetic is int64 arithmetic masked to 32 bits, so nothing here
reads a value back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
#: XLA rewrites a cumulative reduce-window on the CPU into a blocked scan
#: of this base length (sequential within a block, the block totals
#: scanned recursively)
_SCAN_BASE = 16


def key_from_bytes(seed: bytes, device="cuda") -> torch.Tensor:
    """The raw key ``np.frombuffer(seed, np.uint32)[:2]`` as an int64 [2]
    tensor on ``device``."""
    words = np.frombuffer(seed, dtype=np.uint32)[:2].astype(np.int64)
    return torch.from_numpy(words).to(device)


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of the counter pairs (x1, x2) under key (k1, k2);
    int64 tensors of uint32 values, broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x[0], x[1]


def _counts(shape, device):
    n = int(np.prod(shape)) if len(shape) else 1
    c = torch.arange(n, dtype=torch.int64, device=device)
    return (c >> 32) & _M32, c & _M32


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: [num, 2] new keys."""
    hi, lo = _counts((num,), key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element of ``shape`` (uint32 values in int64)."""
    hi, lo = _counts(tuple(shape), key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return (b1 ^ b2).reshape(tuple(shape))


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1) from the 23
    high bits as a mantissa."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return torch.clamp(bits.to(torch.int32).view(torch.float32) - 1.0, min=0.0)


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum`` of a float32 vector as the reference's CPU backend
    computes it: blocks of ``_SCAN_BASE`` summed left to right, the
    exclusive scan of the block totals (recursively, the same way) added
    to each block. Every add is an elementwise float32 add, so every
    device gives the same bits."""
    n = x.shape[0]
    b = _SCAN_BASE
    nb = -(-n // b)
    X = torch.zeros((nb * b,), dtype=x.dtype, device=x.device)
    X[:n] = x
    X = X.view(nb, b)
    cols = [X[:, 0]]
    for j in range(1, b):
        cols.append(cols[-1] + X[:, j])
    inner = torch.stack(cols, dim=1)
    if nb == 1:
        return inner.reshape(-1)[:n]
    tot = xla_cumsum(inner[:, -1].contiguous())
    excl = torch.cat([torch.zeros((1,), dtype=x.dtype, device=x.device), tot[:-1]])
    return (inner + excl[:, None]).reshape(-1)[:n]


def choice(key: torch.Tensor, n: int, shape, p: torch.Tensor) -> torch.Tensor:
    """``jax.random.choice(key, n, shape, p=p)`` with replacement: int64
    indices in [0, n) of ``shape``."""
    if p.shape != (n,):
        raise ValueError(f"p has shape {tuple(p.shape)}, expected ({n},)")
    p_cuml = xla_cumsum(p.to(torch.float32))
    r = p_cuml[-1] * (1.0 - uniform(key, shape))
    return torch.searchsorted(p_cuml, r.reshape(-1)).reshape(tuple(shape))
