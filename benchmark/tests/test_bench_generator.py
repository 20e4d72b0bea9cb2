"""The TPC-H generator at a tiny scale factor on the CPU: deterministic from
the seed, and keeping clause 4.2.3's rules it copies."""

import torch

from harness import tpch
from harness.reference import order_index

SF = 0.004


def gen(seed=2**31 + 7):
    return tpch.Generator(seed, SF, "cpu")


def test_same_seed_same_tables_other_seed_other():
    a, b, c = gen(), gen(), gen(11)
    for name in ("l_orderkey", "l_extendedprice", "l_shipdate",
                 "o_orderstatus", "p_brand", "s_nationkey", "o_custkey"):
        assert torch.equal(a.column(name), b.column(name)), name
    assert not torch.equal(a.column("l_partkey"), c.column("l_partkey"))


def test_a_column_does_not_depend_on_what_was_drawn_before():
    a, b = gen(), gen()
    a.column("l_tax")
    a.column("o_orderpriority")
    assert torch.equal(a.column("l_discount"), b.column("l_discount"))


def test_cardinalities():
    g = gen()
    assert g.num_rows("orders") == 6000
    assert g.num_rows("customer") == 600 and g.num_rows("part") == 800
    assert g.num_rows("supplier") == 40 and g.num_rows("nation") == 25
    assert 6000 <= g.num_rows("lineitem") <= 7 * 6000


def test_sparse_keys_and_lines_per_order():
    g = gen()
    ok = g.column("o_orderkey")
    assert torch.all((ok - 1) % 32 < 8)
    assert torch.equal(order_index(ok), torch.arange(ok.shape[0]))
    per = torch.bincount(order_index(g.column("l_orderkey")),
                         minlength=ok.shape[0])
    assert per.min() >= 1 and per.max() <= 7
    assert torch.all(g.column("o_custkey") % 3 != 0)


def test_dates_off_the_order_date():
    g = gen()
    od = g.column("o_orderdate")[order_index(g.column("l_orderkey"))]
    ship, commit = g.column("l_shipdate"), g.column("l_commitdate")
    receipt = g.column("l_receiptdate")
    assert g.column("o_orderdate").min() >= tpch.ORDER_DATE_FIRST
    assert g.column("o_orderdate").max() <= tpch.ORDER_DATE_LAST
    for d, lo, hi in ((ship - od, 1, 121), (commit - od, 30, 90),
                      (receipt - ship, 1, 30)):
        assert d.min() >= lo and d.max() <= hi


def test_flags_and_status_from_the_lines():
    g = gen()
    rf, ls = g.column("l_returnflag"), g.column("l_linestatus")
    n = tpch.RETURNFLAGS.index("N")
    late = g.column("l_receiptdate") > tpch.CURRENT_DATE
    assert torch.equal(rf == n, late)
    assert torch.equal(ls == 1, g.column("l_shipdate") > tpch.CURRENT_DATE)
    oi = order_index(g.column("l_orderkey"))
    n_orders = g.num_rows("orders")
    lines = torch.bincount(oi, minlength=n_orders)
    shipped = torch.bincount(oi, weights=(ls == 0).double(),
                             minlength=n_orders).long()
    status = g.column("o_orderstatus")
    want = torch.where(shipped == lines, 0, torch.where(shipped == 0, 1, 2))
    assert torch.equal(status.long(), want)


def test_prices_and_suppliers():
    g = gen()
    pk = g.column("l_partkey")
    assert torch.equal(g.column("l_extendedprice"),
                       g.column("l_quantity") * tpch.retail_cents(pk))
    s = g.column("l_suppkey")
    assert s.min() >= 1 and s.max() <= g.num_rows("supplier")
    assert g.column("l_discount").max() <= 10
    assert g.column("l_tax").max() <= 8


def test_supplier_names_as_bytes():
    g = gen()
    mat, lens = g.vocab("s_name").byte_matrix(g.column("s_name")[:3])
    got = [bytes(mat[i, :lens[i]].tolist()).decode() for i in range(3)]
    assert got == ["Supplier#000000001", "Supplier#000000002",
                   "Supplier#000000003"]
