"""TPC-H Q6, the forecasting revenue change (clause 2.4.6).

    sum(l_extendedprice * l_discount) where l_shipdate >= DATE and
    l_shipdate < DATE + 1 year and l_discount between DISCOUNT - 0.01 and
    DISCOUNT + 0.01 and l_quantity < QUANTITY

The year's end through add_months, as chip_smoke.py's P18 plans it.
"""

from harness.reference import add_months, date_days

TABLES = {"lineitem": ["l_quantity", "l_extendedprice", "l_discount",
                       "l_shipdate"]}
SCANS = ("lineitem",)


def draw(rng):
    """Clause 2.4.6.3: DATE the first of January of a year in
    [1993, 1997], DISCOUNT in [0.02, 0.09], QUANTITY in [24, 25]."""
    return {"year": rng.randint(1993, 1997), "discount": rng.randint(2, 9),
            "quantity": rng.randint(24, 25)}


def build(q, params):
    col, pr, F = q.col, q.m.pred, q.m.F
    start = q.date(date_days(params["year"], 1, 1))
    d = params["discount"]
    cond = q.all_of(
        pr.GreaterThanOrEqual(col("l_shipdate"), start),
        pr.LessThan(col("l_shipdate"), F.add_months(start, 12)),
        pr.GreaterThanOrEqual(col("l_discount"), q.money_lit(d - 1, 2)),
        pr.LessThanOrEqual(col("l_discount"), q.money_lit(d + 1, 2)),
        pr.LessThan(col("l_quantity"), q.money_lit(params["quantity"], 0)))
    return (q.df("lineitem", TABLES["lineitem"]).filter(cond)
            .agg((F.sum(col("l_extendedprice") * col("l_discount")),
                  "revenue")))


def reference(r, params):
    sd, disc = r.col("l_shipdate"), r.col("l_discount")
    start = date_days(params["year"], 1, 1)
    d = params["discount"]
    keep = (sd >= start) & (sd < add_months(start, 12)) \
        & (disc >= d - 1) & (disc <= d + 1) \
        & (r.col("l_quantity") < params["quantity"])
    return [tuple(r.sums(r.col("l_extendedprice") * disc, 4, 2,
                         mask=keep))]


def compare(got, want, r, out):
    out.rows(got, want, "q6")
