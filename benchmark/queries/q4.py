"""TPC-H Q4, the order priority checking query (clause 2.4.4).

    count(*) by o_orderpriority of the orders with o_orderdate in
    [DATE, DATE + 3 months) that have a line with l_commitdate <
    l_receiptdate (EXISTS: a left-semi join on the order key), ordered by
    o_orderpriority

as chip_smoke.py's P12 builds it; the quarter's end is the literal
Spark's optimizer folds DATE + interval '3' month into.
"""

import torch

from harness.reference import add_months, date_days, order_index

TABLES = {"orders": ["o_orderkey", "o_orderdate", "o_orderpriority"],
          "lineitem": ["l_orderkey", "l_commitdate", "l_receiptdate"]}
SCANS = ("orders", "lineitem")


def draw(rng):
    """Clause 2.4.4.3: DATE the first of a month from January 1993 to
    October 1997."""
    k = rng.randint(0, 57)
    return {"year": 1993 + k // 12, "month": 1 + k % 12}


def _span(params):
    start = date_days(params["year"], params["month"], 1)
    return start, add_months(start, 3)


def build(q, params):
    col, pr, F = q.col, q.m.pred, q.m.F
    start, end = _span(params)
    orders = q.df("orders", TABLES["orders"]).filter(pr.And(
        pr.GreaterThanOrEqual(col("o_orderdate"), q.date(start)),
        pr.LessThan(col("o_orderdate"), q.date(end))))
    lines = q.df("lineitem", TABLES["lineitem"]).filter(
        pr.LessThan(col("l_commitdate"), col("l_receiptdate")))
    return (orders.join(lines, left_on="o_orderkey", right_on="l_orderkey",
                        how="left_semi")
            .group_by("o_orderpriority").agg((F.count(), "order_count"))
            .sort("o_orderpriority"))


def reference(r, params):
    if "q4_has_late" not in r.cache:
        late = r.col("l_commitdate") < r.col("l_receiptdate")
        oi = order_index(r.col("l_orderkey")[late])
        r.cache["q4_has_late"] = torch.bincount(
            oi, minlength=r.n_orders()) > 0
    start, end = _span(params)
    od = r.col("o_orderdate")
    keep = r.cache["q4_has_late"] & (od >= start) & (od < end)
    vocab = r.vocab("o_orderpriority")
    counts = torch.bincount(r.col("o_orderpriority")[keep].long(),
                            minlength=len(vocab)).tolist()
    return [(vocab[k], counts[k]) for k in range(len(vocab)) if counts[k]]


def compare(got, want, r, out):
    out.rows(got, want, "q4")
