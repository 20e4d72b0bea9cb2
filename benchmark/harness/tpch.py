"""TPC-H tables made on the device from a seed, by the generation rules of
clause 4.2.3 (TPC-H v3), at any scale factor.

Every column is drawn from a generator of its own, seeded from the run's
seed and the column's name, so a table holds the same values whichever
other columns a mix asks for, and the same seed gives the same tables on
the same device. Values are kept in their exact integer form: money in
cents, discount and tax in percent, quantities in units, dates in days
since the epoch, strings as int32 codes into a `Vocab`. `harness.tables`
turns them into the port's columns of the configuration's types; the
plain references read them as they are.

The rules kept (clause 4.2.3; the same that chip_smoke.py's
`tpch_join_data`, `q19_data`, `decimal_lines` and `q3_types_data` apply):
sparse order keys (8 of every 32), 1-7 lines an order, o_custkey never a
multiple of 3, l_suppkey by the partsupp formula over a random part,
l_extendedprice = l_quantity x p_retailprice, the ship, commit and
receipt dates off the order date, l_returnflag and l_linestatus against
CURRENTDATE, and o_orderstatus from its lines' statuses.

A query file that reads a column or a table this module does not make
brings it in its `COLUMNS` ({name: ColumnDef}) and `ROWS` ({table: rows at
a scale factor}); the harness hands them to the `Generator`, which makes
them as it makes its own. A configuration may name another generator
module by file (its `generator` key), one that subclasses `Generator`.
"""

from __future__ import annotations

import hashlib
from typing import (Callable, Dict, Iterable, List, NamedTuple,
                    Optional, Sequence, Tuple)

import torch

#: clause 4.2.3: STARTDATE 1992-01-01, ENDDATE - 151 days 1998-08-02,
#: CURRENTDATE 1995-06-17 (days since the epoch)
ORDER_DATE_FIRST = 8035
ORDER_DATE_LAST = 10440
CURRENT_DATE = 9298

ORDER_PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED",
                    "5-LOW")
ORDER_STATUSES = ("F", "O", "P")
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")
NATIONS = ("ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA",
           "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ", "JAPAN",
           "JORDAN", "KENYA", "MOROCCO", "PERU", "CHINA", "ROMANIA",
           "SAUDI ARABIA", "VIETNAM", "RUSSIA", "UNITED KINGDOM",
           "UNITED STATES", "MOZAMBIQUE")
RETURNFLAGS = ("A", "N", "R")
LINESTATUSES = ("F", "O")
#: clause 4.2.2.13's value lists
BRANDS = tuple(f"Brand#{m}{n}" for m in range(1, 6) for n in range(1, 6))
CONTAINERS = tuple(f"{a} {b}" for a in ("SM", "LG", "MED", "JUMBO", "WRAP")
                   for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK",
                             "CAN", "DRUM"))
SHIPINSTRUCTS = ("DELIVER IN PERSON", "COLLECT COD", "NONE",
                 "TAKE BACK RETURN")
SHIPMODES = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")

#: each column's kind: "int" (LONG), "int32" (INT), "date", "money" (cents),
#: "percent", "quantity", or "string" (codes into a Vocab)
KINDS = {
    "l_orderkey": "int", "l_partkey": "int", "l_suppkey": "int",
    "l_quantity": "quantity", "l_extendedprice": "money",
    "l_discount": "percent", "l_tax": "percent",
    "l_returnflag": "string", "l_linestatus": "string",
    "l_shipdate": "date", "l_commitdate": "date", "l_receiptdate": "date",
    "l_shipinstruct": "string", "l_shipmode": "string",
    "o_orderkey": "int", "o_custkey": "int", "o_orderstatus": "string",
    "o_orderdate": "date", "o_orderpriority": "string",
    "o_shippriority": "int32",
    "c_custkey": "int", "c_mktsegment": "string",
    "p_partkey": "int", "p_brand": "string", "p_size": "int32",
    "p_container": "string",
    "s_suppkey": "int", "s_name": "string", "s_nationkey": "int32",
    "n_nationkey": "int32", "n_name": "string",
}


def table_of(column: str) -> str:
    return {"l": "lineitem", "o": "orders", "c": "customer", "p": "part",
            "s": "supplier", "n": "nation"}[column.split("_")[0]]


class ColumnDef(NamedTuple):
    """A column a query file adds: its table, its kind (as KINDS), how a
    `Generator` makes it (from `Generator.randint` draws and the columns
    it already makes), and for a string column the values its codes
    index."""
    table: str
    kind: str
    make: Callable[["Generator"], torch.Tensor]
    vocab: Optional["Vocab"] = None


class Vocab:
    """The values a string column's codes index: a fixed list, or
    `prefix` + the code + 1 in `digits` zero-padded digits (s_name's
    "Supplier#000000001"), made on demand."""

    def __init__(self, values: Sequence[str] = (), prefix: str = "",
                 digits: int = 0, size: int = 0):
        self.values = tuple(values)
        self.prefix, self.digits = prefix, digits
        self.size = len(self.values) if self.values else size

    def __len__(self):
        return self.size

    def __getitem__(self, code: int) -> str:
        if self.values:
            return self.values[code]
        return f"{self.prefix}{code + 1:0{self.digits}d}"

    def index(self, value: str) -> int:
        return self.values.index(value)

    @property
    def width(self) -> int:
        """Bytes of the longest value."""
        if self.values:
            return max(len(v.encode()) for v in self.values)
        return len(self.prefix) + self.digits

    def byte_matrix(self, codes: torch.Tensor) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
        """(uint8 (n, width) bytes, int64 (n,) lengths) of each code's
        value, on the codes' device."""
        dev = codes.device
        if self.values:
            enc = [v.encode() for v in self.values]
            mat = torch.zeros(len(enc), self.width, dtype=torch.uint8)
            for k, b in enumerate(enc):
                mat[k, :len(b)] = torch.tensor(list(b), dtype=torch.uint8)
            lens = torch.tensor([len(b) for b in enc], dtype=torch.int64)
            return mat.to(dev)[codes.long()], lens.to(dev)[codes.long()]
        prefix = torch.tensor(list(self.prefix.encode()), dtype=torch.uint8,
                              device=dev)
        num = codes.long() + 1
        powers = 10 ** torch.arange(self.digits - 1, -1, -1, device=dev)
        digits = ((num[:, None] // powers[None, :]) % 10 + 48).to(
            torch.uint8)
        mat = torch.cat([prefix.expand(codes.shape[0], -1), digits], 1)
        return mat, torch.full((codes.shape[0],), self.width,
                               dtype=torch.int64, device=dev)


VOCABS = {
    "l_returnflag": Vocab(RETURNFLAGS), "l_linestatus": Vocab(LINESTATUSES),
    "l_shipinstruct": Vocab(SHIPINSTRUCTS), "l_shipmode": Vocab(SHIPMODES),
    "o_orderstatus": Vocab(ORDER_STATUSES),
    "o_orderpriority": Vocab(ORDER_PRIORITIES),
    "c_mktsegment": Vocab(SEGMENTS), "p_brand": Vocab(BRANDS),
    "p_container": Vocab(CONTAINERS), "n_name": Vocab(NATIONS),
}


def row_counts(sf: float) -> Dict[str, int]:
    """Clause 4.2.5's cardinalities (lineitem follows from the draws)."""
    return {"orders": int(sf * 1_500_000), "customer": int(sf * 150_000),
            "part": int(sf * 200_000), "supplier": int(sf * 10_000),
            "nation": 25}


def retail_cents(partkey: torch.Tensor) -> torch.Tensor:
    """P_RETAILPRICE in cents (clause 4.2.3)."""
    return 90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)


class Generator:
    """The tables of one seed at scale factor `sf` on `device`, made
    column by column as they are asked for; `columns` and `rows` add the
    columns and tables that query files bring."""

    def __init__(self, seed: int, sf: float, device,
                 columns: Optional[Dict[str, ColumnDef]] = None,
                 rows: Optional[Dict[str, Callable[[float], int]]] = None):
        self.seed, self.sf = int(seed), sf
        self.device = torch.device(device)
        self.counts = row_counts(sf)
        for table, count in (rows or {}).items():
            self.counts.setdefault(table, int(count(sf)))
        self.extra = {k: v for k, v in (columns or {}).items()
                      if k not in KINDS}
        self._cols: Dict[str, torch.Tensor] = {}

    def _gen(self, name: str) -> torch.Generator:
        digest = hashlib.blake2b(f"{self.seed}:{name}".encode(),
                                 digest_size=8).digest()
        g = torch.Generator(device=self.device)
        g.manual_seed(int.from_bytes(digest, "little") >> 1)
        return g

    def randint(self, name: str, low: int, high: int, n: int,
                dtype=torch.int64) -> torch.Tensor:
        """n draws from [low, high] (both ends included)."""
        return torch.randint(low, high + 1, (n,), generator=self._gen(name),
                             device=self.device, dtype=dtype)

    def kind(self, name: str) -> str:
        if name in KINDS:
            return KINDS[name]
        if name in self.extra:
            return self.extra[name].kind
        raise KeyError(f"no TPC-H column {name!r}")

    def table(self, name: str) -> str:
        return self.extra[name].table if name in self.extra \
            else table_of(name)

    def vocab(self, name: str) -> Vocab:
        if name in self.extra:
            return self.extra[name].vocab
        if name == "s_name":
            return Vocab(prefix="Supplier#", digits=9,
                         size=self.counts["supplier"])
        return VOCABS[name]

    def column(self, name: str) -> torch.Tensor:
        if name not in self._cols:
            self._cols[name] = self.extra[name].make(self) \
                if name in self.extra else getattr(self, "_" + name)()
        return self._cols[name]

    def num_rows(self, table: str) -> int:
        if table == "lineitem":
            return int(self._owner().shape[0])
        return self.counts[table]

    # -- orders ------------------------------------------------------------
    def _o_orderkey(self):
        i = torch.arange(self.counts["orders"], device=self.device)
        return (i // 8) * 32 + i % 8 + 1

    def _o_orderdate(self):
        return self.randint("o_orderdate", ORDER_DATE_FIRST,
                             ORDER_DATE_LAST, self.counts["orders"],
                             torch.int32)

    def _o_custkey(self):
        n_cust = max(self.counts["customer"], 3)
        cust = self.randint("o_custkey", 1, n_cust, self.counts["orders"])
        return torch.where(cust % 3 == 0, torch.clamp(cust - 1, min=1), cust)

    def _o_orderpriority(self):
        return self.randint("o_orderpriority", 0, 4, self.counts["orders"],
                             torch.int32)

    def _o_shippriority(self):
        return torch.zeros(self.counts["orders"], dtype=torch.int32,
                           device=self.device)

    def _o_orderstatus(self):
        n_orders = self.counts["orders"]
        owner, nlines = self._owner(), self._nlines()
        shipped = torch.zeros(n_orders, dtype=torch.int64,
                              device=self.device)
        shipped.index_add_(0, owner, (self.column("l_shipdate")
                                      <= CURRENT_DATE).long())
        return torch.where(shipped == nlines, 0,
                           torch.where(shipped == 0, 1, 2)).to(torch.int32)

    # -- lineitem ----------------------------------------------------------
    def _nlines(self):
        if "_nlines" not in self._cols:
            self._cols["_nlines"] = self.randint(
                "l_linenumber", 1, 7, self.counts["orders"])
        return self._cols["_nlines"]

    def _owner(self):
        """Each line's order row."""
        if "_owner" not in self._cols:
            nl = self._nlines()
            self._cols["_owner"] = torch.repeat_interleave(
                torch.arange(nl.shape[0], device=self.device), nl)
        return self._cols["_owner"]

    def _n_lines(self) -> int:
        return int(self._owner().shape[0])

    def _l_orderkey(self):
        return self.column("o_orderkey")[self._owner()]

    def _l_partkey(self):
        return self.randint("l_partkey", 1, max(self.counts["part"], 1),
                             self._n_lines())

    def _l_suppkey(self):
        part = self.column("l_partkey")
        n_supp = max(self.counts["supplier"], 4)
        corner = self.randint("l_suppkey", 0, 3, part.shape[0])
        return (part + corner * (n_supp // 4 + (part - 1) // n_supp)) \
            % n_supp + 1

    def _l_quantity(self):
        return self.randint("l_quantity", 1, 50, self._n_lines())

    def _l_extendedprice(self):
        return self.column("l_quantity") \
            * retail_cents(self.column("l_partkey"))

    def _l_discount(self):
        return self.randint("l_discount", 0, 10, self._n_lines())

    def _l_tax(self):
        return self.randint("l_tax", 0, 8, self._n_lines())

    def _l_shipdate(self):
        od = self.column("o_orderdate")[self._owner()]
        return od + self.randint("l_shipdate", 1, 121, od.shape[0],
                                  torch.int32)

    def _l_commitdate(self):
        od = self.column("o_orderdate")[self._owner()]
        return od + self.randint("l_commitdate", 30, 90, od.shape[0],
                                  torch.int32)

    def _l_receiptdate(self):
        ship = self.column("l_shipdate")
        return ship + self.randint("l_receiptdate", 1, 30, ship.shape[0],
                                    torch.int32)

    def _l_returnflag(self):
        receipt = self.column("l_receiptdate")
        returned = torch.where(
            self.randint("l_returnflag", 0, 1, receipt.shape[0]) == 0,
            RETURNFLAGS.index("R"), RETURNFLAGS.index("A"))
        return torch.where(receipt <= CURRENT_DATE, returned,
                           RETURNFLAGS.index("N")).to(torch.int32)

    def _l_linestatus(self):
        return (self.column("l_shipdate") > CURRENT_DATE).to(torch.int32)

    def _l_shipinstruct(self):
        return self.randint("l_shipinstruct", 0, len(SHIPINSTRUCTS) - 1,
                             self._n_lines(), torch.int32)

    def _l_shipmode(self):
        return self.randint("l_shipmode", 0, len(SHIPMODES) - 1,
                             self._n_lines(), torch.int32)

    # -- customer, part, supplier, nation ----------------------------------
    def _c_custkey(self):
        return torch.arange(1, self.counts["customer"] + 1,
                            device=self.device)

    def _c_mktsegment(self):
        return self.randint("c_mktsegment", 0, len(SEGMENTS) - 1,
                             self.counts["customer"], torch.int32)

    def _p_partkey(self):
        return torch.arange(1, self.counts["part"] + 1, device=self.device)

    def _p_brand(self):
        # Brand#MN, M and N each uniform over 1..5
        return self.randint("p_brand", 0, len(BRANDS) - 1,
                             self.counts["part"], torch.int32)

    def _p_size(self):
        return self.randint("p_size", 1, 50, self.counts["part"],
                             torch.int32)

    def _p_container(self):
        return self.randint("p_container", 0, len(CONTAINERS) - 1,
                             self.counts["part"], torch.int32)

    def _s_suppkey(self):
        return torch.arange(1, self.counts["supplier"] + 1,
                            device=self.device)

    def _s_name(self):
        return torch.arange(self.counts["supplier"], dtype=torch.int32,
                            device=self.device)

    def _s_nationkey(self):
        return self.randint("s_nationkey", 0, 24, self.counts["supplier"],
                             torch.int32)

    def _n_nationkey(self):
        return torch.arange(25, dtype=torch.int32, device=self.device)

    def _n_name(self):
        return torch.arange(25, dtype=torch.int32, device=self.device)

    # -- what a set-up asks for --------------------------------------------
    def columns_by_table(self, columns: Iterable[str]
                         ) -> Dict[str, List[str]]:
        """Columns grouped by their table, each table's in KINDS order,
        then the added columns in the order they were added."""
        want = set(columns)
        out: Dict[str, List[str]] = {}
        for c in list(KINDS) + list(self.extra):
            if c in want:
                out.setdefault(self.table(c), []).append(c)
        unknown = want - set(KINDS) - set(self.extra)
        if unknown:
            raise KeyError(f"no TPC-H column {sorted(unknown)}")
        return out
