"""Counter-based threefry2x32 random numbers, bit for bit those of
``jax.random`` (port of the parts of ``jax._src.prng`` and
``jax._src.random`` that the clustering engine draws from).

A key is a (2,) int64 tensor holding two uint32 words, as
``jax.random.PRNGKey`` returns them.  Every draw is a pure function of
its key, so the port's k-means++ and random starts pick the same points as
the reference's for the same seed.  The semantics are those of jax with
``jax_threefry_partitionable=True`` (the default since jax 0.5): a draw of
shape S hashes the flat indices of S as (hi, lo) counter words, and
``split`` does the same over the key shape.

uint32 arithmetic is carried in int64 and masked to 32 bits: PyTorch has
no shifts for ``torch.uint32`` on the CPU.  Keys and raw draws live on
the CPU; ``choice`` with probabilities runs its cumsum and search on the
probabilities' device.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
#: row length of XLA's CPU rewrite of a cumulative sum
_SCAN_BASE = 16

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """The threefry2x32 hash (20 rounds) of counter words (x1, x2) under key
    words (k1, k2); every value an int64 holding a uint32."""
    ks = (k1, k2, (k1 ^ k2 ^ 0x1BD11BDA) & _M32)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _M32
    return x[0], x[1]


def PRNGKey(seed: int) -> torch.Tensor:
    """Key of an integer seed: its high and low 32-bit words (a negative
    seed is taken as its int32 two's complement, as jax's x32 mode does)."""
    seed = int(seed)
    if seed < 0:
        seed &= _M32
    return torch.tensor([(seed >> 32) & _M32, seed & _M32],
                        dtype=torch.int64)


def _hash_iota(key: torch.Tensor, shape: tuple):
    """threefry of the flat index of every element of ``shape``, split
    into (hi, lo) counter words."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], idx >> 32, idx & _M32)
    return b1.reshape(shape), b2.reshape(shape)


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``num`` new keys: (*num, 2)."""
    b1, b2 = _hash_iota(key, _shape(num))
    return torch.stack([b1, b2], dim=-1)


def bits(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """Uniform 32-bit words of ``shape`` (int64 holding uint32)."""
    b1, b2 = _hash_iota(key, _shape(shape))
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """float32 uniform in [0, 1): 23 random mantissa bits under the
    exponent of 1.0, minus 1."""
    f = ((bits(key, shape) >> 9) | 0x3F800000).to(torch.int32)
    return f.view(torch.float32) - 1.0


def randint(key: torch.Tensor, shape: Shape, minval: int,
            maxval: int) -> torch.Tensor:
    """int32 in [minval, maxval): two words per value, folded by the
    span with uint32 arithmetic, as ``jax.random.randint`` does."""
    minval, maxval = int(minval), int(maxval)
    k1, k2 = split(key)
    higher, lower = bits(k1, shape), bits(k2, shape)
    span = (maxval - minval) & _M32 if maxval > minval else 1
    mult = ((2 ** 16 % span) ** 2 & _M32) % span      # the square wraps
    off = ((higher % span) * mult) & _M32
    off = ((off + lower % span) & _M32) % span
    return (off + minval).to(torch.int32)


def xla_cumsum(p: torch.Tensor) -> torch.Tensor:
    """float32 inclusive cumsum along the last axis in the order XLA's CPU
    backend adds (``jnp.cumsum``): rows of 16 summed left to right, each
    row offset by the cumsum of the row totals before it, recursively.
    Leading axes are independent members (a vmapped cumsum)."""
    n = p.shape[-1]
    lead = p.shape[:-1]
    m = -(-n // _SCAN_BASE)
    rows = torch.zeros(lead + (m * _SCAN_BASE,), dtype=p.dtype,
                       device=p.device)
    rows[..., :n] = p
    rows = rows.reshape(lead + (m, _SCAN_BASE))
    acc = torch.zeros(lead + (m,), dtype=p.dtype, device=p.device)
    cols = []
    for j in range(_SCAN_BASE):
        acc = acc + rows[..., j]
        cols.append(acc)
    inner = torch.stack(cols, -1)
    if m == 1:
        return inner[..., 0, :n]
    pre = xla_cumsum(inner[..., -1])
    excl = torch.cat([pre.new_zeros(lead + (1,)), pre[..., :-1]], -1)
    return (inner + excl[..., None]).reshape(lead + (-1,))[..., :n]


def searchsorted_left(sorted_arr: torch.Tensor,
                      query: torch.Tensor) -> torch.Tensor:
    """Left insertion index by jax's fixed-depth binary search
    (``jnp.searchsorted(method='scan')``), so the answer matches jax's
    even where ``sorted_arr`` is not monotone.  sorted_arr (..., n),
    query (..., q) with the same leading axes → (..., q) int32."""
    n = sorted_arr.shape[-1]
    low = torch.zeros(query.shape, dtype=torch.int64, device=query.device)
    high = torch.full(query.shape, n, dtype=torch.int64, device=query.device)
    for _ in range(int(math.ceil(math.log2(n + 1)))):
        mid = (low + high) // 2
        go_left = query <= torch.gather(sorted_arr, -1, mid)
        low, high = torch.where(go_left, low, mid), torch.where(go_left, mid,
                                                                high)
    return high.to(torch.int32)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """A random permutation of range(n): stable sorts by fresh 32-bit keys,
    ceil(3 ln n / ln(2^32 - 1)) rounds."""
    x = torch.arange(n, dtype=torch.int32, device=key.device)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(_M32)))
    for _ in range(rounds):
        key, sub = split(key)
        order = torch.sort(bits(sub, (n,)), stable=True).indices
        x = x[order]
    return x


def choice(key: torch.Tensor, n: int, shape: Shape = (), replace: bool = True,
           p=None) -> torch.Tensor:
    """Draws from range(n) (int32 of ``shape``): uniform with or without
    replacement, or by probabilities ``p`` (n,) with replacement — a
    cumsum and a search of p_cuml[-1] · (1 - uniform).  ``p`` (..., n)
    draws for every leading member with the one key, as a vmap over
    members does (→ (..., *shape))."""
    shape = _shape(shape)
    n_draws = math.prod(shape)
    if p is None:
        if replace:
            return randint(key, shape, 0, n)
        if n_draws > n:
            raise ValueError(f"cannot take {n_draws} of {n} without "
                             "replacement")
        return permutation(key, n)[:n_draws].reshape(shape)
    if not replace:
        raise NotImplementedError("choice(p=..., replace=False) (the Gumbel "
                                  "top-k draw) is not ported")
    p = p.to(torch.float32)
    if p.shape[-1] != n:
        raise ValueError(f"p has shape {tuple(p.shape)}, want (..., {n})")
    lead = p.shape[:-1]
    cum = xla_cumsum(p)
    r = cum[..., -1:] * (1.0 - uniform(key, shape).to(p.device).reshape(-1))
    return searchsorted_left(cum, r).reshape(lead + shape)
