"""GenerateExec (exec/generate.py): explode and posexplode, outer and not,
over list columns, against the JAX package on the CPU.

The input carries string and list payload columns (their output buckets
are measured, one host read a batch), null and empty arrays, arrays built
by an expression (CreateArray: element slots for inactive rows too) and
a string split (the last two against Python). Rows, positions and
payloads exact.
"""

import pytest

from spark_rapids_tpu.exec import basic as jb
from spark_rapids_tpu.exec import generate as jg
from spark_rapids_tpu.expr import collectionexprs as jce
from spark_rapids_tpu.expr import core as jc
from spark_rapids_tpu.expr import stringexprs as jse

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.exec import basic as tb
from spark_rapids_tpu_torch.exec import generate as tg
from spark_rapids_tpu_torch.expr import collectionexprs as tce
from spark_rapids_tpu_torch.expr import core as tc
from spark_rapids_tpu_torch.expr import stringexprs as tse

from test_torch_arrays import AI, AS, INTS, STRS, both
from test_torch_jax_ref import jax_aliases, one_torch_thread


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), one_torch_thread():
        yield


DATA = {"k": [1, 2, 3, 4, 5, 6], "a": INTS, "s": STRS,
        "str": ["x,y", None, "", "a,,b", "z", "p,q"]}
TYPES = {"k": tt.LONG, "a": AI, "s": AS, "str": tt.STRING}


def _run(gen, outer, position):
    jbatch, tbatch = both(DATA, TYPES)
    out = []
    for ex, b, batch, g in ((jg, jb, jbatch, gen[0]), (tg, tb, tbatch,
                                                       gen[1])):
        node = ex.GenerateExec(g, b.InMemoryScanExec([batch, batch],
                                                     batch.schema),
                               outer=outer, position=position,
                               elem_name="e", pos_name="p")
        out.append(([r for x in node.execute() for r in x.to_pylist()],
                    node))
    return out


@pytest.mark.parametrize("outer, position", [(False, False), (True, False),
                                              (False, True), (True, True)])
def test_explode_of_a_column_matches_jax(outer, position):
    (jrows, _), (trows, node) = _run((jc.col("a"), tc.col("a")), outer,
                                     position)
    assert trows == jrows
    # the payload columns (a string list among them) were measured once a
    # batch
    assert node.metrics["measureHostReads"].value == 2
    n = sum(len(v) for v in INTS if v) + (2 if outer else 0)
    assert len(trows) == 2 * n


def _python_posexplode(values):
    """posexplode_outer of one batch of (row, list) pairs in Python: each
    element with its position, then (as the reference emits them) a row
    with a null element for each empty or null list."""
    out = [row + (p, v) for row, vals in values
           for p, v in enumerate(vals or ())]
    return out + [row + (None, None) for row, vals in values if not vals]


@pytest.mark.parametrize("which", ["strings", "created", "split"])
def test_explode_of_expressions_matches_jax(which):
    """A split's explode against the JAX package; a string list's and a
    CreateArray's against Python (an explode of each runs above)."""
    gens = {"strings": (jc.col("s"), tc.col("s")),
            "created": (jce.CreateArray(jc.col("k"), jc.col("k")),
                        tce.CreateArray(tc.col("k"), tc.col("k"))),
            "split": (jse.StringSplit(jc.col("str"), ","),
                      tse.StringSplit(tc.col("str"), ","))}[which]
    if which == "split":
        (jrows, _), (trows, _) = _run(gens, True, True)
        assert trows == jrows
        return
    _, tbatch = both(DATA, TYPES)
    node = tg.GenerateExec(gens[1], tb.InMemoryScanExec(
        [tbatch, tbatch], tbatch.schema), outer=True, position=True,
        elem_name="e", pos_name="p")
    trows = [r for x in node.execute() for r in x.to_pylist()]
    rows = list(zip(*DATA.values()))
    lists = [r[2] for r in rows] if which == "strings" \
        else [[r[0], r[0]] for r in rows]
    assert trows == _python_posexplode(list(zip(rows, lists))) * 2
