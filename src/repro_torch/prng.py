"""threefry2x32 in PyTorch, bit for bit the stream of ``jax.random``.

The simulator's behaviour is a pure function of its integer state and
one counter-based random stream, so the port reproduces the reference's
stream exactly: the same key gives the same bits.  Only the calls the
engine makes are here: ``prng_key``,
``split``, ``fold_in``, ``uniform`` (float32 in [0, 1)) and ``randint``
(int32, jax's two-draw modulus algorithm).

jax derives its bits in one of two ways, chosen by its
``jax_threefry_partitionable`` flag: the partitionable mode (the default
of current jax) hashes each element's own 64-bit index, the original
mode (the default before jax 0.5) hashes the flat index range cut into
two halves.  ``split``, ``random_bits``, ``uniform`` and ``randint`` take
``partitionable=`` to pick one; ``fold_in`` is the same in both.

A key is an int32 tensor ``[2]`` holding the two uint32 words as a bit
pattern (the engine keeps it in its state, on the state's device).
``split``, ``random_bits``, ``uniform`` and ``randint`` also take a
batch of keys ``[..., 2]`` (a replica axis) and return ``[..., *shape]``:
each key's draws are bitwise those of a call with that key alone, as
``jax.vmap`` of the same call gives them.  ``fold_in`` takes one key.

The arithmetic runs in int64 tensors masked to 32 bits: shifts on
``torch.uint32`` are not implemented on every backend, and an int64
holding a uint32 value shifts, adds and rotates exactly.

Every function is plain tensor code with no host synchronisation, so a
key on the card stays on the card.
"""
from __future__ import annotations

import torch

__all__ = ["prng_key", "split", "fold_in", "random_bits", "uniform",
           "randint", "threefry2x32"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block cipher (20 rounds) on uint32 values held in
    int64 tensors; ``k1``/``k2`` broadcast against the counters."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _MASK
    x1 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _words(key: torch.Tensor, n_dims: int = 0):
    """The key's two words as int64 tensors of shape ``key.shape[:-1] +
    (1,) * n_dims``: a batch of keys broadcasts against ``n_dims``
    counter axes."""
    k = key.to(torch.int64) & _MASK
    tail = (1,) * n_dims
    return (k[..., 0].reshape(k.shape[:-1] + tail),
            k[..., 1].reshape(k.shape[:-1] + tail))


def _to_key(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    # uint32 values -> int32 bit patterns (two's complement wrap)
    return torch.stack([b1, b2], dim=-1).to(torch.int32)


def _counts(shape, device):
    """Row-major flat index of every element as (hi, lo) uint32 words
    (``jax._src.prng.iota_2x32_shape``)."""
    n = 1
    for s in shape:
        n *= int(s)
    flat = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return flat >> 32, flat & _MASK


def _threefry_flat(k1, k2, count: torch.Tensor) -> torch.Tensor:
    """``jax._src.prng.threefry_2x32`` on a flat count vector: the two
    halves (zero-padded to even length) are the cipher's two words.
    ``k1``/``k2`` are ``[..., 1]``: the batch axes stay apart from the
    counter axis, which is halved alone."""
    n = count.shape[0]
    if n % 2:
        count = torch.cat([count, count.new_zeros(1)])
    x0, x1 = count.chunk(2)
    return torch.cat(threefry2x32(k1, k2, x0, x1), dim=-1)[..., :n]


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit signed integer seed."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} does not fit in int32")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64,
                        device=device).to(torch.int32)


def split(key: torch.Tensor, num: int = 2, *,
          partitionable: bool = True) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``[..., num, 2]`` int32 keys."""
    k1, k2 = _words(key, 1)
    if not partitionable:
        count = torch.arange(2 * num, dtype=torch.int64, device=key.device)
        return _threefry_flat(k1, k2, count).reshape(
            key.shape[:-1] + (num, 2)).to(torch.int32)
    hi, lo = _counts((num,), key.device)
    return _to_key(*threefry2x32(k1, k2, hi, lo))


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for one key ``[2]`` and a uint32
    ``data``."""
    if key.shape != (2,):
        raise ValueError(f"fold_in takes one key [2], got {tuple(key.shape)}")
    data = int(data)
    if not 0 <= data <= _MASK:
        raise ValueError(f"fold_in data {data} does not fit in uint32")
    k1, k2 = _words(key)
    x = torch.tensor([0, data], dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(k1, k2, x[:1], x[1:])
    return _to_key(b1[0], b2[0])


def random_bits(key: torch.Tensor, shape, *,
                partitionable: bool = True) -> torch.Tensor:
    """32 random bits per element as int64 values in ``[0, 2**32)``,
    ``[..., *shape]`` for keys ``[..., 2]``."""
    shape = tuple(shape)
    hi, lo = _counts(shape, key.device)
    if not partitionable:
        if hi.numel() >= _MASK:
            raise ValueError("the original threefry mode draws fewer than "
                             "2**32 - 1 values per call")
        k1, k2 = _words(key, 1)
        return _threefry_flat(k1, k2, lo.reshape(-1)).reshape(
            key.shape[:-1] + shape)
    k1, k2 = _words(key, len(shape))
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape, *,
            partitionable: bool = True) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1).

    The top 23 bits become the mantissa of a float in [1, 2); subtracting
    1 is exact, as it is in the reference.
    """
    bits = (random_bits(key, shape, partitionable=partitionable) >> 9) \
        | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def randint(key: torch.Tensor, shape, minval: int, maxval: int, *,
            partitionable: bool = True) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32.

    Two 32-bit draws per element combined modulo the span, in uint32
    arithmetic with wrap-around, as ``jax._src.random._randint`` does.
    """
    minval, maxval = int(minval), int(maxval)
    if not -(1 << 31) <= minval <= maxval <= (1 << 31) - 1:
        raise ValueError(f"randint range [{minval}, {maxval}) is not int32")
    k_hi, k_lo = split(key, 2, partitionable=partitionable).unbind(-2)
    higher = random_bits(k_hi, shape, partitionable=partitionable)
    lower = random_bits(k_lo, shape, partitionable=partitionable)
    span = max(maxval - minval, 1)
    multiplier = (((1 << 16) % span) ** 2 & _MASK) % span
    offset = ((higher % span) * multiplier) & _MASK
    offset = ((offset + lower % span) & _MASK) % span
    return (offset + minval).to(torch.int32)
