"""The `jax.random` threefry2x32 stream as integer torch ops.

The JAX package draws its stochastic rounding, extra-trees thresholds,
bynode masks and GOSS samples from `jax.random`.  A torch generator
cannot replay those streams, so this module reimplements the default
JAX PRNG bit for bit: threefry2x32 with the partitionable counter
layout (`jax_threefry_partitionable=True`, the default of jax 0.9).

* `PRNGKey(seed)`: key (0, seed mod 2^32), as JAX builds it from a
  Python int in its default 32-bit mode.
* `fold_in(key, data)`: threefry2x32(key, (0, data)).
* `split(key, num)`: key i = threefry2x32(key, (hi(i), lo(i))).
* `random_bits(key, shape)`: flat index i hashed as the counter
  (hi(i), lo(i)); the word is the XOR of the two output halves.
* `uniform(key, shape)`: float32 in [0, 1) from the top 23 bits.

uint32 words are held in int64 tensors and masked after every add and
shift, so the same code runs on the CPU and on the card.  A key is an
int64 tensor of shape [2].
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The threefry2x32 block function (20 rounds) on uint32 words held
    in int64 tensors; returns the two output words."""
    ks = (k1 & _M32, k2 & _M32, (k1 ^ k2 ^ _PARITY) & _M32)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x[0], x[1]


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` for a Python int seed."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`."""
    zero = key.new_zeros(1)
    y1, y2 = threefry2x32(key[0], key[1], zero, zero + (int(data) & _M32))
    return torch.cat([y1, y2])


def _counters(num: int, device):
    i = torch.arange(num, dtype=torch.int64, device=device)
    return i >> 32, i & _M32


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: [num, 2] keys."""
    hi, lo = _counters(num, key.device)
    y1, y2 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([y1, y2], dim=1)


def random_bits(key: torch.Tensor, shape: Union[int, Sequence[int]],
                device=None) -> torch.Tensor:
    """32 random bits per element (int64 holding a uint32)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    dev = key.device if device is None else torch.device(device)
    key = key.to(dev)
    num = 1
    for d in shape:
        num *= int(d)
    hi, lo = _counters(num, dev)
    y1, y2 = threefry2x32(key[0], key[1], hi, lo)
    return (y1 ^ y2).reshape(shape)


def uniform(key: torch.Tensor, shape: Union[int, Sequence[int]],
            device=None) -> torch.Tensor:
    """`jax.random.uniform(key, shape)`: float32 in [0, 1)."""
    bits = random_bits(key, shape, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0
