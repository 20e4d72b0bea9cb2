"""Z-order expressions — the counterpart of spark_rapids_tpu/expr/zorder.py
(reference org/.../rapids/zorder/: GpuInterleaveBits + JNI ZOrder, used
by Delta's OPTIMIZE ZORDER BY).

Each INT or LONG key becomes an order-preserving unsigned rank (its
sign bit flipped), and the keys' bits interleave MSB-first into one LONG
morton code. The JAX package shifts as uint64; torch has no uint64
shifts on the card, so the port works in int64 (ops/decimal128's rule):
a bit is taken as `(x >> k) & 1`, which the arithmetic shift leaves
exact, and set by `1 << k`, bit 63 included. Codes match bit for bit.
"""

from __future__ import annotations

import torch

from ..columnar.column import Column
from ..types import LONG
from .core import Expression

_SIGN = -(1 << 63)


def interleave_bits(cols) -> Column:
    """The morton code of 1 to 8 INT/LONG columns: bit b of the code
    (from the top) is bit 63 - b // n of key b % n, 64 // n bits a key,
    the code's top bit flipped so that the signed LONG sorts as the
    unsigned code; NULL where any key is."""
    n = len(cols)
    bits_per = 64 // n
    valid = cols[0].validity
    for c in cols[1:]:
        valid = valid & c.validity
    ranks = [c.data.to(torch.int64) ^ _SIGN for c in cols]
    out = torch.zeros_like(ranks[0])
    for b in range(n * bits_per):
        src_bit = 63 - b // n
        dst_bit = n * bits_per - 1 - b
        bit = (ranks[b % n] >> src_bit) & 1
        out |= bit << dst_bit
    out = out ^ _SIGN
    return Column(torch.where(valid, out, 0), valid, LONG)


class InterleaveBits(Expression):
    """interleave_bits(k1, k2, ...) -> LONG morton code."""

    def __init__(self, *children: Expression):
        if not 1 <= len(children) <= 8:
            raise ValueError("interleave_bits takes 1 to 8 keys")
        self.children = tuple(children)

    def with_children(self, cs):
        return InterleaveBits(*cs)

    @property
    def data_type(self):
        return LONG

    def columnar_eval(self, batch) -> Column:
        return interleave_bits([c.columnar_eval(batch)
                                for c in self.children])
