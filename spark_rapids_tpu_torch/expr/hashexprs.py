"""Hash expressions — the counterpart of spark_rapids_tpu/expr/hashexprs.py:
Murmur3Hash (Spark `hash`) and XxHash64 (reference HashFunctions.scala).

Both go through ops/hashing.py: on CUDA tensors every run of fixed-width
columns of `hash` is one launch of the Hopper murmur3 chain
(ops/murmur3_lanes.py) per four columns, and string columns hash their
bytes in torch; XxHash64 is torch ops on either device.
"""

from __future__ import annotations

import torch

from ..columnar.column import Column
from ..ops.hashing import murmur3_batch, xxhash64_batch
from ..types import INT, LONG
from .core import Expression


class Murmur3Hash(Expression):
    def __init__(self, *children: Expression, seed: int = 42):
        self.children = tuple(children)
        self.seed = seed

    def with_children(self, children):
        return Murmur3Hash(*children, seed=self.seed)

    @property
    def data_type(self):
        return INT

    @property
    def nullable(self):
        return False

    def columnar_eval(self, batch):
        cols = [c.columnar_eval(batch) for c in self.children]
        h = murmur3_batch(cols, self.seed)
        return Column(h, torch.ones(h.shape[0], dtype=torch.bool,
                                    device=h.device), INT)


class XxHash64(Expression):
    def __init__(self, *children: Expression, seed: int = 42):
        self.children = tuple(children)
        self.seed = seed

    def with_children(self, children):
        return XxHash64(*children, seed=self.seed)

    @property
    def data_type(self):
        return LONG

    @property
    def nullable(self):
        return False

    def columnar_eval(self, batch):
        cols = [c.columnar_eval(batch) for c in self.children]
        h = xxhash64_batch(cols, self.seed)
        return Column(h, torch.ones(h.shape[0], dtype=torch.bool,
                                    device=h.device), LONG)
