"""What a query module gets to build its DataFrame: the port's modules,
the session's tables, and literals in the configuration's types.

A query module under benchmark/queries/ defines

- `TABLES`: {table: [columns it reads]};
- `SCANS`: the tables its plan scans, one entry per FROM reference (Q21
  names lineitem three times): the rows it counts toward `rows_per_s`;
- `draw(rng)`: its substitution parameters (clause 2.4.x.3) from a
  `random.Random`, as a dict;
- `build(q, params)`: the `DataFrame` (q is a `QueryContext`);
- `reference(r, params)`: the expected result from a
  `harness.reference.RefContext`;
- `rows(r, want)` (optional): `want` as the rows `collect()` returns,
  where `reference` gives more than the rows;
- `compare(got, want, r, out)`: the rows `collect()` returned against
  `want`, recorded into `out` (a `harness.reference.Compared`);
- `COLUMNS` and `ROWS` (optional): the columns and tables it reads that
  harness/tpch.py does not make (a `tpch.ColumnDef` each; a table's rows
  at a scale factor).

`draw` gets a fresh `random.Random` state for every query of the window;
the mix's options for the query are added to what it draws.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict

from . import tables


def port_modules():
    """The port's functions, expressions and types."""
    from spark_rapids_tpu_torch import types as t
    from spark_rapids_tpu_torch.api import functions
    from spark_rapids_tpu_torch.expr import core, predicates
    return SimpleNamespace(core=core, pred=predicates, F=functions, t=t)


class QueryContext:
    """A session over one configuration's batches."""

    def __init__(self, session, batches: Dict[str, tuple], money: str,
                 prune: bool = True):
        self.m = port_modules()
        self.session = session
        self._batches = batches
        self.money = money
        self.prune = prune
        self.base, self.precision, self.scale = tables.parse_money(money)

    def df(self, table: str, columns=None):
        """The table as a DataFrame; with `columns` and `prune` (the
        configuration's `prune_scans`), only those, as Spark's column
        pruning leaves a scan (the port's planner prunes none)."""
        batches, schema = self._batches[table]
        df = self.session.from_batches(batches, schema)
        if self.prune and columns is not None \
                and list(columns) != schema.names:
            df = df.select(*[self.m.core.col(c) for c in columns])
        return df

    def col(self, name: str):
        return self.m.core.col(name)

    def lit(self, value):
        return self.m.core.lit(value)

    def date(self, days: int):
        """A DATE literal of days since the epoch."""
        return self.m.core.Literal(int(days), self.m.t.DATE)

    def money_lit(self, units: int, k: int):
        """The money value units / 10^k in the configuration's type."""
        if self.base == "DOUBLE":
            return self.m.core.lit(units / 10 ** k)
        return self.m.core.Literal(
            int(units) * 10 ** (self.scale - k),
            self.m.t.DecimalType(self.precision, self.scale))

    def one(self):
        """The 1 of `1 - l_discount` and `1 + l_tax`."""
        return self.m.core.lit(1.0 if self.base == "DOUBLE" else 1)

    def all_of(self, *es):
        out = es[0]
        for e in es[1:]:
            out = self.m.pred.And(out, e)
        return out

    def any_of(self, *es):
        out = es[0]
        for e in es[1:]:
            out = self.m.pred.Or(out, e)
        return out
