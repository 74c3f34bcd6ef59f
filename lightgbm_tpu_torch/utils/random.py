"""The `jax.random` threefry2x32 stream as integer torch ops.

The JAX package draws its stochastic rounding, extra-trees thresholds,
bynode masks and GOSS samples from `jax.random`.  A torch generator
cannot replay those streams, so this module reimplements the default
JAX PRNG bit for bit: threefry2x32 with the partitionable counter
layout (`jax_threefry_partitionable=True`, the default of jax 0.9).

* `PRNGKey(seed)`: key (0, seed mod 2^32), as JAX builds it from a
  Python int in its default 32-bit mode.
* `fold_in(key, data)`: threefry2x32(key, (0, data)); `data` may be a
  1-D tensor of tags, which gives one key per tag, [T, 2].
* `split(key, num)`: key i = threefry2x32(key, (hi(i), lo(i))).
* `random_bits(key, shape)`: flat index i hashed as the counter
  (hi(i), lo(i)); the word is the XOR of the two output halves.
* `uniform(key, shape)`: float32 in [0, 1) from the top 23 bits.  A
  batch of keys [T, 2] draws [T, *shape] in one pass, row t equal to
  `uniform(key[t], shape)`.
* `topk_mask(u, k)`: the exactly-k subset `u >= top_k(u, k)[-1]` along
  the last axis (the JAX package's per-node column sampling).

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


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in(key, data)` for an int (a key [2]) or for a
    1-D tensor of tags (keys [T, 2])."""
    if not isinstance(data, torch.Tensor):
        return fold_in(key, key.new_full((1,), int(data) & _M32))[0]
    d = data.to(device=key.device, dtype=torch.int64) & _M32
    y1, y2 = threefry2x32(key[0], key[1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=1)


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
    """32 random bits per element (int64 holding a uint32); keys [T, 2]
    give [T, *shape]."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    dev = key.device if device is None else torch.device(device)
    key = key.to(dev)
    num = 1
    for d in shape:
        num *= int(d)
    hi, lo = _counters(num, dev)
    if key.dim() == 2:
        shape = (key.shape[0],) + shape
    keys = key.reshape(-1, 2)
    y1, y2 = threefry2x32(keys[:, :1], keys[:, 1:], hi, lo)
    return (y1 ^ y2).reshape(shape)


def uniform(key: torch.Tensor, shape: Union[int, Sequence[int]],
            device=None) -> torch.Tensor:
    """`jax.random.uniform(key, shape)`: float32 in [0, 1)."""
    bits = random_bits(key, shape, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def topk_mask(u: torch.Tensor, k: int) -> torch.Tensor:
    """Exactly-k subset along the last axis: `u >= top_k(u, k)[-1]`."""
    return u >= torch.topk(u, k, dim=-1).values[..., -1:]
