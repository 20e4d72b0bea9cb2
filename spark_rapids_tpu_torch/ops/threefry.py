"""The counter-based random bits of JAX's default PRNG, in torch — so that
SampleExec (exec/basic.py) keeps the same rows for a seed as the JAX
package's, which draws `jax.random.uniform(fold_in(key(seed), batch),
(capacity,), float32)`.

Threefry-2x32 (Salmon et al., SC'11) with JAX's 20 rounds and key
schedule, on int64 tensors holding u32 values (PyTorch has no shifts or
adds for uint32 on every device), each step masked to 32 bits:

  key(seed)          (seed >> 32, seed & 0xFFFFFFFF) of the 64-bit seed
  fold_in(key, d)    threefry(key, (0, d))
  bits(key, n)       threefry(key, (0, iota)) -> x0 ^ x1, the counters laid
                     out as JAX lays them out with
                     jax_threefry_partitionable=True (its default since
                     0.5): counter i is the 64-bit iota (hi, lo) = (0, i)
  uniform(bits)      bits >> 9 | 0x3F800000 as a float32, minus 1.0

tests/test_torch_sample_sort.py holds the bits to jax.random's.
"""

from __future__ import annotations

from typing import Tuple

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[int, int]


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M32


def threefry2x32(key: Key, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of counter pairs (x0, x1), int64 lanes of
    u32 values, under the u32 key pair."""
    k0, k1 = key[0] & _M32, key[1] & _M32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x = [(x0 + ks[0]) & _M32, (x1 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _M32
    return x[0], x[1]


def key(seed: int) -> Key:
    """jax.random.key(seed) for a 64-bit seed."""
    s = int(seed) & ((1 << 64) - 1)
    return (s >> 32) & _M32, s & _M32


def fold_in(k: Key, data: int) -> Key:
    """jax.random.fold_in(k, data) for a u32 `data`."""
    x0, x1 = threefry2x32(k, torch.zeros(1, dtype=torch.int64),
                          torch.tensor([int(data) & _M32]))
    return int(x0[0]), int(x1[0])


def random_bits(k: Key, n: int, device=None) -> torch.Tensor:
    """jax.random.bits(k, (n,), uint32) as int64 lanes of u32 values."""
    counters = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(k, torch.zeros_like(counters), counters)
    return b0 ^ b1


def uniform(k: Key, n: int, device=None) -> torch.Tensor:
    """jax.random.uniform(k, (n,), float32): [0, 1) from the top 23 bits."""
    bits = (random_bits(k, n, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
