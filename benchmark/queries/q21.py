"""TPC-H Q21, the suppliers who kept orders waiting (clause 2.4.21).

    l1 (l_receiptdate > l_commitdate) left-semi-joined to l2 on the order
    key with l2_suppkey <> l_suppkey (EXISTS), left-anti-joined to l3
    (late lines) with the same condition (NOT EXISTS), then joined to
    supplier, to the orders with o_orderstatus = 'F' and to the nation
    NATION; count(*) by s_name, the first 100 by numwait desc, s_name

as chip_smoke.py's `q21_df` builds it.
"""

import torch

from harness.reference import order_index

TABLES = {"lineitem": ["l_orderkey", "l_suppkey", "l_commitdate",
                       "l_receiptdate"],
          "supplier": ["s_suppkey", "s_name", "s_nationkey"],
          "orders": ["o_orderkey", "o_orderstatus"],
          "nation": ["n_nationkey", "n_name"]}
SCANS = ("lineitem", "lineitem", "lineitem", "supplier", "orders",
         "nation")
LIMIT = 100


def draw(rng):
    """Clause 2.4.21.3: NATION one of the 25."""
    from harness.tpch import NATIONS
    return {"nation": rng.choice(NATIONS)}


def _ne(q, a, b):
    return q.m.pred.Not(q.m.pred.EqualTo(q.col(a), q.col(b)))


def build(q, params):
    col, lit, pr, F = q.col, q.lit, q.m.pred, q.m.F
    lines = q.df("lineitem", TABLES["lineitem"])
    l1 = lines.filter(pr.GreaterThan(col("l_receiptdate"),
                                     col("l_commitdate")))
    l2 = lines.select(col("l_orderkey").alias("l2_orderkey"),
                      col("l_suppkey").alias("l2_suppkey"))
    l3 = lines.select(col("l_orderkey").alias("l3_orderkey"),
                      col("l_suppkey").alias("l3_suppkey"),
                      col("l_commitdate").alias("l3_commitdate"),
                      col("l_receiptdate").alias("l3_receiptdate")).filter(
        pr.GreaterThan(col("l3_receiptdate"), col("l3_commitdate")))
    return (l1.join(l2, left_on="l_orderkey", right_on="l2_orderkey",
                    how="left_semi", condition=_ne(q, "l2_suppkey",
                                                   "l_suppkey"))
            .join(l3, left_on="l_orderkey", right_on="l3_orderkey",
                  how="left_anti", condition=_ne(q, "l3_suppkey",
                                                 "l_suppkey"))
            .join(q.df("supplier", TABLES["supplier"]),
                  left_on="l_suppkey", right_on="s_suppkey")
            .join(q.df("orders", TABLES["orders"]).filter(
                pr.EqualTo(col("o_orderstatus"), lit("F"))),
                  left_on="l_orderkey", right_on="o_orderkey")
            .join(q.df("nation", TABLES["nation"]).filter(
                pr.EqualTo(col("n_name"), lit(params["nation"]))),
                  left_on="s_nationkey", right_on="n_nationkey")
            .group_by("s_name").agg((F.count(), "numwait"))
            .sort((col("numwait"), False), "s_name").limit(LIMIT))


def _waiting(r):
    """Per line: late, another supplier on the order, no other supplier
    late on it, and the order's status 'F' (the nation aside)."""
    lok, supp = r.col("l_orderkey"), r.col("l_suppkey")
    late = r.col("l_receiptdate") > r.col("l_commitdate")
    oi = order_index(lok)
    n_orders = r.n_orders()
    pair = oi * (int(supp.max()) + 1) + supp

    def per_order(mask):
        return torch.bincount(oi[mask], minlength=n_orders)

    def per_pair(mask):
        u, counts = torch.unique(pair[mask], return_counts=True)
        if u.shape[0] == 0:
            return torch.zeros_like(pair)
        pos = torch.clamp(torch.searchsorted(u, pair), max=u.shape[0] - 1)
        return torch.where(u[pos] == pair, counts[pos], 0)
    everything = torch.ones_like(late)
    other_lines = per_order(everything)[oi] - per_pair(everything)
    other_late = per_order(late)[oi] - per_pair(late)
    status = r.col("o_orderstatus")[oi]
    return late & (other_lines > 0) & (other_late == 0) \
        & (status == r.vocab("o_orderstatus").index("F"))


def reference(r, params):
    if "q21_waiting" not in r.cache:
        r.cache["q21_waiting"] = _waiting(r)
    supp = r.col("l_suppkey")
    nation = r.vocab("n_name").index(params["nation"])
    keep = r.cache["q21_waiting"] \
        & (r.col("s_nationkey")[supp - 1] == nation)
    counts = torch.bincount(supp[keep] - 1,
                            minlength=r.col("s_suppkey").shape[0])
    idx = torch.nonzero(counts).flatten().tolist()
    n = counts[idx].tolist() if idx else []
    names = r.vocab("s_name")
    rows = sorted(((names[k], c) for k, c in zip(idx, n)),
                  key=lambda row: (-row[1], row[0]))
    return rows[:LIMIT]


def compare(got, want, r, out):
    out.rows(got, want, "q21")
