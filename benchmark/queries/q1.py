"""TPC-H Q1, the pricing summary report (clause 2.4.1).

    l_shipdate <= date '1998-12-01' - interval DELTA day, grouped and
    ordered by l_returnflag, l_linestatus: sum_qty, sum_base_price,
    sum_disc_price, sum_charge, avg_qty, avg_price, avg_disc, count_order

On DOUBLE money all eight aggregates are there (chip_smoke.py's P6). On
DECIMAL money sum_charge and the three averages are left out: the port
tags off the decimal128 multiply of sum_charge and the decimal average
(P17), a departure its configuration file lists. A mix that gives Q1 the
option {"aggregates": "all"} asks for all eight on DECIMAL too, and the
reference holds them: sum_charge exact at scale 3 x s, each average
rounded half up to scale s + 4, as Spark types avg of DECIMAL(p, s).
"""

import torch

from harness.reference import date_days

TABLES = {"lineitem": ["l_quantity", "l_extendedprice", "l_discount",
                       "l_tax", "l_returnflag", "l_linestatus",
                       "l_shipdate"]}
SCANS = ("lineitem",)
END = date_days(1998, 12, 1)


def draw(rng):
    """Clause 2.4.1.3: DELTA uniform over [60, 120]."""
    return {"delta": rng.randint(60, 120)}


def full(money_base, params):
    """Whether the query carries all eight aggregates."""
    return money_base == "DOUBLE" or params.get("aggregates") == "all"


def build(q, params):
    col, F = q.col, q.m.F
    price, disc = col("l_extendedprice"), col("l_discount")
    disc_price = price * (q.one() - disc)
    cutoff = F.date_sub(q.date(END), q.lit(params["delta"]))
    aggs = [(F.sum("l_quantity"), "sum_qty"),
            (F.sum(price), "sum_base_price"),
            (F.sum(disc_price), "sum_disc_price")]
    if full(q.base, params):
        aggs += [(F.sum(disc_price * (q.one() + col("l_tax"))),
                  "sum_charge"),
                 (F.avg("l_quantity"), "avg_qty"), (F.avg(price), "avg_price"),
                 (F.avg(disc), "avg_disc")]
    aggs.append((F.count(), "count_order"))
    return (q.df("lineitem", TABLES["lineitem"])
            .filter(q.m.pred.LessThanOrEqual(col("l_shipdate"), cutoff))
            .group_by("l_returnflag", "l_linestatus")
            .agg(*aggs)
            .sort("l_returnflag", "l_linestatus"))


def reference(r, params):
    keep = r.col("l_shipdate") <= END - params["delta"]
    rf, ls = r.col("l_returnflag"), r.col("l_linestatus")
    n_ls = len(r.vocab("l_linestatus"))
    group = (rf.long() * n_ls + ls.long())
    n_groups = len(r.vocab("l_returnflag")) * n_ls
    qty, price = r.col("l_quantity"), r.col("l_extendedprice")
    disc, tax = r.col("l_discount"), r.col("l_tax")
    dp = price * (100 - disc)

    def sums(values, k, factors):
        return r.sums(values, k, factors, group, n_groups, keep)
    counts = torch.bincount(group[keep], minlength=n_groups).tolist()
    cols = [sums(qty, 0, 1), sums(price, 2, 1), sums(dp, 4, 2)]
    if full(r.base, params):
        cols.append(sums(dp * (100 + tax), 6, 3))
        avg = [sums(qty, 0, 1), sums(price, 2, 1), sums(disc, 2, 1)]
    rows = []
    for g in range(n_groups):
        n = counts[g]
        if not n:
            continue
        row = [r.vocab("l_returnflag")[g // n_ls],
               r.vocab("l_linestatus")[g % n_ls]] + [c[g] for c in cols]
        if full(r.base, params):
            row += [mean(a[g], n, r) for a in avg]
        rows.append(tuple(row + [n]))
    return rows


def mean(total, n, r):
    """avg of a column: the float mean on DOUBLE; on DECIMAL(p, s), the
    unscaled mean at scale s + 4, rounded half up (every sum here is
    positive)."""
    if r.base == "DOUBLE":
        return total / n
    return (2 * total * 10 ** 4 + n) // (2 * n)


def compare(got, want, r, out):
    out.rows(got, want, "q1")
