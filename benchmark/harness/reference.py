"""What the plain references share: the tables in their exact integer form,
sums in a chosen arithmetic, and the comparison of a query's rows.

A reference works from the generator's tensors (harness/tpch.py), made
anew from the seed once the program's state is freed; it imports nothing
of the port. Its sums run in one of three arithmetics:

- "exact": integer sums (int64 over chunks small enough not to overflow,
  added as Python ints), so a DECIMAL result is exact to the last digit
  and a DOUBLE result is the exact value rounded once;
- "float64" and "float32": each row's value scaled to its decimal value
  and summed in that float type: the controls, the reference computed in
  the precision below the one the configuration states (DOUBLE for a
  DECIMAL configuration, float32 for a DOUBLE one).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from . import tables, tpch

#: rows summed in one int64 index_add: a row's value stays under 2^40
#: (l_extendedprice x (100 - discount) x (100 + tax) is under 1.2e11)
CHUNK = 1 << 22


def order_index(keys: torch.Tensor) -> torch.Tensor:
    """Row of each sparse order key (clause 4.2.3's 8 of every 32)."""
    k = keys - 1
    return (k // 32) * 8 + k % 32


class RefContext:
    """The reference's view of one configuration's tables."""

    def __init__(self, gen: tpch.Generator, money: str,
                 arithmetic: str = "exact"):
        self.gen, self.money = gen, money
        self.base, _, self.scale = tables.parse_money(money)
        if arithmetic not in ("exact", "float64", "float32"):
            raise ValueError(f"arithmetic {arithmetic!r}")
        self.arithmetic = arithmetic
        self.cache: Dict[str, object] = {}

    def col(self, name: str) -> torch.Tensor:
        return self.gen.column(name)

    def vocab(self, name: str) -> tpch.Vocab:
        return self.gen.vocab(name)

    def n_orders(self) -> int:
        return self.gen.counts["orders"]

    # -- results in the configuration's types ------------------------------
    def out(self, num: int, k: int, factors: int):
        """An exact value num / 10^k, made of `factors` money factors, as
        the program returns it: a float for DOUBLE, the unscaled integer
        of DECIMAL's product scale (factors x scale) otherwise."""
        if self.base == "DOUBLE":
            return num / 10 ** k
        shift = factors * self.scale - k
        return num * 10 ** shift if shift >= 0 else None

    def sums(self, values: torch.Tensor, k: int, factors: int,
             group: Optional[torch.Tensor] = None, n_groups: int = 1,
             mask: Optional[torch.Tensor] = None) -> List:
        """Per group, the sum of `values` (exact int64 row values of scale
        k) over the rows in `mask`, as `out` gives it; None for a group
        with no row."""
        dev = values.device
        if mask is not None:
            values = values[mask]
            group = group[mask] if group is not None else None
        if group is None:
            group = torch.zeros(values.shape[0], dtype=torch.int64,
                                device=dev)
        counts = torch.bincount(group, minlength=n_groups).tolist()
        if self.arithmetic != "exact":
            ft = torch.float64 if self.arithmetic == "float64" \
                else torch.float32
            acc = torch.zeros(n_groups, dtype=ft, device=dev)
            acc.index_add_(0, group, values.to(ft) / 10.0 ** k)
            res = []
            for c, s in zip(counts, acc.tolist()):
                if not c:
                    res.append(None)
                elif self.base == "DOUBLE":
                    res.append(float(s))
                else:
                    res.append(int(round(s * 10 ** (factors * self.scale))))
            return res
        total = [0] * n_groups
        for s in range(0, values.shape[0], CHUNK):
            acc = torch.zeros(n_groups, dtype=torch.int64, device=dev)
            acc.index_add_(0, group[s:s + CHUNK], values[s:s + CHUNK])
            for g, v in enumerate(acc.tolist()):
                total[g] += v
        return [self.out(t, k, factors) if c else None
                for t, c in zip(total, counts)]

    def per_row_sums(self, values: torch.Tensor, index: torch.Tensor,
                     n: int) -> torch.Tensor:
        """Sums of `values` (exact int64 row values) by `index` into n
        slots, in the reference's arithmetic: int64 when exact (a slot
        holds a few rows), else the float type, unscaled."""
        if self.arithmetic == "exact":
            acc = torch.zeros(n, dtype=torch.int64, device=values.device)
            acc.index_add_(0, index, values)
            return acc
        ft = torch.float64 if self.arithmetic == "float64" \
            else torch.float32
        acc = torch.zeros(n, dtype=ft, device=values.device)
        acc.index_add_(0, index, values.to(ft))
        return acc


class Compared:
    """What a comparison found: values that differ where they must be
    equal (keys, counts, strings, row counts, order, every DECIMAL), and
    the widest relative gap of a DOUBLE value from the reference's."""

    def __init__(self):
        self.mismatches = 0
        self.rel_gap = 0.0
        self.first: Optional[str] = None

    def miss(self, what: str, n: int = 1):
        self.mismatches += n
        if self.first is None:
            self.first = what

    def value(self, got, want, where: str):
        if isinstance(want, float):
            if not isinstance(got, float) or math.isnan(got):
                self.miss(f"{where}: {got!r} != {want!r}")
                return
            gap = abs(got - want) / max(abs(want), 1e-300)
            if gap > self.rel_gap:
                self.rel_gap = gap
            return
        if got != want:
            self.miss(f"{where}: {got!r} != {want!r}")

    def rows(self, got: Sequence[tuple], want: Sequence[tuple],
             label: str):
        """Row by row in order: every value by `value`, and each row
        missing or extra as a mismatch."""
        if len(got) != len(want):
            self.miss(f"{label}: {len(got)} rows != {len(want)}",
                      abs(len(got) - len(want)))
        for i, (g, w) in enumerate(zip(got, want)):
            if len(g) != len(w):
                self.miss(f"{label} row {i}: {g!r} != {w!r}")
                continue
            for j, (a, b) in enumerate(zip(g, w)):
                self.value(a, b, f"{label} row {i} col {j}")


def date_days(y: int, m: int, d: int) -> int:
    import datetime
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def add_months(days: int, months: int) -> int:
    """Days since the epoch of `days` + `months` (the first of a month
    stays the first)."""
    import datetime
    d = datetime.date(1970, 1, 1) + datetime.timedelta(days=days)
    y, m = divmod(d.month - 1 + months, 12)
    return date_days(d.year + y, m + 1, d.day)
