"""TPC-H Q19, the discounted revenue query (clause 2.4.19).

    sum(l_extendedprice * (1 - l_discount)) over lineitem x part on the
    part key where any of three terms holds: p_brand = BRANDi,
    p_container in the term's four containers, l_quantity in [QUANTITYi,
    QUANTITYi + 10], p_size between 1 and 5, 10 or 15, l_shipmode in
    ('AIR', 'AIR REG'), l_shipinstruct = 'DELIVER IN PERSON'

as chip_smoke.py's `q19_df` builds it: the filtered lineitems joined to
the filtered parts with the three-way OR as the join's condition. The
query's text names 'AIR REG', which the data never hold ('REG AIR').
"""

import torch

TABLES = {"lineitem": ["l_partkey", "l_quantity", "l_extendedprice",
                       "l_discount", "l_shipinstruct", "l_shipmode"],
          "part": ["p_partkey", "p_brand", "p_size", "p_container"]}
SCANS = ("lineitem", "part")
CONTAINERS = (("SM CASE", "SM BOX", "SM PACK", "SM PKG"),
              ("MED BAG", "MED BOX", "MED PKG", "MED PACK"),
              ("LG CASE", "LG BOX", "LG PACK", "LG PKG"))
SIZES = (5, 10, 15)
SHIPMODES = ("AIR", "AIR REG")
INSTRUCT = "DELIVER IN PERSON"
SPAN = 10


def draw(rng):
    """Clause 2.4.19.3: QUANTITY1 in [1, 10], QUANTITY2 in [10, 20],
    QUANTITY3 in [20, 30]; BRANDi 'Brand#MN', M and N in [1, 5]."""
    return {"quantities": [rng.randint(1, 10), rng.randint(10, 20),
                           rng.randint(20, 30)],
            "brands": [f"Brand#{rng.randint(1, 5)}{rng.randint(1, 5)}"
                       for _ in range(3)]}


def _terms(params):
    return list(zip(params["brands"], CONTAINERS, params["quantities"],
                    SIZES))


def build(q, params):
    col, lit, pr, F = q.col, q.lit, q.m.pred, q.m.F
    ship = [pr.In(col("l_shipmode"), list(SHIPMODES)),
            pr.EqualTo(col("l_shipinstruct"), lit(INSTRUCT))]
    part_terms, terms_all = [], []
    for brand, containers, qty, size in _terms(params):
        part = [pr.EqualTo(col("p_brand"), lit(brand)),
                pr.In(col("p_container"), list(containers))]
        part_terms.append(q.all_of(*part, pr.LessThanOrEqual(
            col("p_size"), lit(size))))
        terms_all.append(q.all_of(
            *part,
            pr.GreaterThanOrEqual(col("l_quantity"), q.money_lit(qty, 0)),
            pr.LessThanOrEqual(col("l_quantity"),
                               q.money_lit(qty + SPAN, 0)),
            pr.GreaterThanOrEqual(col("p_size"), lit(1)),
            pr.LessThanOrEqual(col("p_size"), lit(size)), *ship))
    lines = q.df("lineitem", TABLES["lineitem"]).filter(q.all_of(*ship))
    parts = q.df("part", TABLES["part"]).filter(pr.And(
        pr.GreaterThanOrEqual(col("p_size"), lit(1)),
        q.any_of(*part_terms)))
    return (lines.join(parts, left_on="l_partkey", right_on="p_partkey",
                       condition=q.any_of(*terms_all))
            .select(col("l_extendedprice"), col("l_discount"))
            .agg((F.sum(col("l_extendedprice")
                        * (q.one() - col("l_discount"))), "revenue")))


def _isin(r, name, values, codes):
    vocab = r.vocab(name)
    hits = [vocab.index(v) for v in values if v in vocab.values]
    return torch.isin(codes, torch.tensor(hits, dtype=codes.dtype,
                                          device=codes.device))


def reference(r, params):
    p = r.col("l_partkey") - 1
    qty = r.col("l_quantity")
    size = r.col("p_size")[p]
    brand, container = r.col("p_brand")[p], r.col("p_container")[p]
    keep = _isin(r, "l_shipmode", SHIPMODES, r.col("l_shipmode")) \
        & _isin(r, "l_shipinstruct", (INSTRUCT,), r.col("l_shipinstruct"))
    any_term = torch.zeros_like(keep)
    for b, containers, q, s in _terms(params):
        any_term |= (_isin(r, "p_brand", (b,), brand)
                     & _isin(r, "p_container", containers, container)
                     & (qty >= q) & (qty <= q + SPAN)
                     & (size >= 1) & (size <= s))
    keep &= any_term
    rev = r.col("l_extendedprice") * (100 - r.col("l_discount"))
    return [tuple(r.sums(rev, 4, 2, mask=keep))]


def compare(got, want, r, out):
    out.rows(got, want, "q19")
