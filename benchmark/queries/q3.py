"""TPC-H Q3, the shipping priority query (clause 2.4.3).

    customer (c_mktsegment = SEGMENT) x orders (o_orderdate < DATE) x
    lineitem (l_shipdate > DATE); revenue = sum(l_extendedprice *
    (1 - l_discount)) by (l_orderkey, o_orderdate, o_shippriority); the
    first 10 by revenue desc, o_orderdate

as chip_smoke.py's P19 builds it.
"""

import torch

from harness.reference import date_days, order_index

TABLES = {"customer": ["c_custkey", "c_mktsegment"],
          "orders": ["o_orderkey", "o_custkey", "o_orderdate",
                     "o_shippriority"],
          "lineitem": ["l_orderkey", "l_extendedprice", "l_discount",
                       "l_shipdate"]}
SCANS = ("customer", "orders", "lineitem")
LIMIT = 10


def draw(rng):
    """Clause 2.4.3.3: SEGMENT one of the five, DATE a day of March
    1995."""
    from harness.tpch import SEGMENTS
    return {"segment": rng.choice(SEGMENTS), "day": rng.randint(1, 31)}


def build(q, params):
    col, pr, F = q.col, q.m.pred, q.m.F
    cut = q.date(date_days(1995, 3, params["day"]))
    cust = q.df("customer", TABLES["customer"]).filter(
        pr.EqualTo(col("c_mktsegment"), q.lit(params["segment"])))
    orders = q.df("orders", TABLES["orders"]).filter(
        pr.LessThan(col("o_orderdate"), cut))
    lines = q.df("lineitem", TABLES["lineitem"]).filter(
        pr.GreaterThan(col("l_shipdate"), cut))
    return (cust.join(orders, left_on="c_custkey", right_on="o_custkey")
            .join(lines, left_on="o_orderkey", right_on="l_orderkey")
            .group_by("l_orderkey", "o_orderdate", "o_shippriority")
            .agg((F.sum(col("l_extendedprice")
                        * (q.one() - col("l_discount"))), "revenue"))
            .sort((col("revenue"), False), "o_orderdate").limit(LIMIT))


def reference(r, params):
    """Every order's revenue (unscaled, scale 4) in the reference's
    arithmetic, whether it qualifies, and the qualifying orders ranked:
    (totals, qualifies, ranked order rows)."""
    seg = r.col("c_mktsegment")
    n_cust = seg.shape[0]
    hit = torch.zeros(n_cust + 1, dtype=torch.bool, device=seg.device)
    hit[r.col("c_custkey")] = seg == r.vocab("c_mktsegment").index(
        params["segment"])
    cut = date_days(1995, 3, params["day"])
    od = r.col("o_orderdate")
    o_ok = hit[r.col("o_custkey")] & (od < cut)
    if "q3_pos" not in r.cache:
        r.cache["q3_pos"] = order_index(r.col("l_orderkey"))
    pos = r.cache["q3_pos"]
    l_ok = o_ok[pos] & (r.col("l_shipdate") > cut)
    rev = r.col("l_extendedprice") * (100 - r.col("l_discount"))
    n = r.n_orders()
    total = r.per_row_sums(rev[l_ok], pos[l_ok], n)
    qual = torch.bincount(pos[l_ok], minlength=n) > 0
    idx = torch.nonzero(qual).flatten()
    # revenue desc, then o_orderdate: a stable sort by date, then by
    # revenue
    by_date = idx[torch.argsort(od[idx], stable=True)]
    ranked = by_date[torch.argsort(-total[by_date], stable=True)]
    return total, qual, ranked


def _row(r, total, i):
    v = total[i].item()
    rev = r.out(int(v), 4, 2) if r.arithmetic == "exact" else (
        float(v) / 1e4 if r.base == "DOUBLE"
        else int(round(float(v) * 10 ** (2 * r.scale - 4))))
    return (int(r.col("o_orderkey")[i]), int(r.col("o_orderdate")[i]),
            int(r.col("o_shippriority")[i]), rev)


def rows(r, want):
    """The first LIMIT rows the reference ranks, as collect() returns
    them."""
    total, _, ranked = want
    return [_row(r, total, i) for i in ranked[:LIMIT].tolist()]


def compare(got, want, r, out):
    """Row by row against the reference's ranking. Where the reference
    ranks orders with equal revenue and date, any of them may stand in
    that place: each such place is held to the tied order whose key the
    program returned."""
    total, qual, ranked = want
    expect = rows(r, want)
    top = ranked[:LIMIT + 64].tolist()
    keys = {}
    for i in top:
        keys.setdefault((total[i].item(), int(r.col("o_orderdate")[i])),
                        []).append(i)
    for k, g in enumerate(got[:len(expect)]):
        i = ranked[k].item()
        tie = keys.get((total[i].item(), int(r.col("o_orderdate")[i])), [])
        if len(tie) > 1 and isinstance(g[0], int):
            j = order_index(torch.tensor(g[0])).item()
            if j in tie:
                expect[k] = _row(r, total, j)
    out.rows(got, expect, "q3")
