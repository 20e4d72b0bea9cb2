"""TPC-H Q1, Q6 and Q3 on their true types (DECIMAL(12, 2) money, DATE
ship and order dates, dictionary-encoded flags and segments), planned
from DataFrames in both packages at a small size, against the JAX
package's rows and an exact oracle (Python ints); the same queries
chip_smoke.py drives as P17, P18 and P19 at SF1.

  * Q1: l_shipdate <= date_sub(DATE '1998-12-01', 90), sums of
    DECIMAL(12, 2) to DECIMAL(22, 2) and of DECIMAL(26, 4) to
    DECIMAL(36, 4) (decimal128), count(*), by the two string flags;
  * Q6: a grand sum of DECIMAL(25, 4) to DECIMAL(35, 4) under date,
    decimal and add_months bounds;
  * Q3: customer x orders x lineitem with c_mktsegment = 'BUILDING' on
    the codes, a decimal128 revenue by three keys, TopN(10) by it.

Every decimal matches to the last digit.
"""

from types import SimpleNamespace

import pytest

import jax.numpy as jnp

from spark_rapids_tpu import types as jt
from spark_rapids_tpu.api import functions as jF
from spark_rapids_tpu.api import session as jsession
from spark_rapids_tpu.columnar import encoded as jenc
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import Column as JColumn
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.expr import predicates as jpred

from spark_rapids_tpu_torch.columnar.encoded import DictionaryColumn

import chip_smoke as cs
from test_torch_jax_ref import jax_aliases
from test_torch_planner import active_confs

JAX = SimpleNamespace(t=jt, core=jcore, pred=jpred, F=jF, session=jsession)


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs():
        yield


def _jax_type(dt):
    if type(dt).__name__ == "DecimalType":
        return jt.DecimalType(dt.precision, dt.scale)
    return {"StringType": jt.STRING, "DateType": jt.DATE, "LongType": jt.LONG,
            "IntegerType": jt.INT}[type(dt).__name__]


def jax_batch(tb):
    """The JAX package's batch of the same bytes as the port's `tb`."""
    cols = []
    for c in tb.columns:
        v = jnp.asarray(c.validity.numpy())
        if isinstance(c, DictionaryColumn):
            cols.append(jenc.DictionaryColumn(
                jnp.asarray(c.codes.numpy()), jnp.asarray(c.dict_data.numpy()),
                jnp.asarray(c.dict_offsets.numpy()), v, jt.STRING))
        else:
            cols.append(JColumn(jnp.asarray(c.data.numpy()), v,
                                _jax_type(c.dtype)))
    schema = jt.Schema(tuple(jt.StructField(f.name, _jax_type(f.data_type))
                             for f in tb.schema.fields))
    return JBatch(cols, tb.num_rows_host, schema)


@pytest.fixture(scope="module")
def inputs():
    d19 = cs.q19_data(n_part=1024, n_line=6000, seed=5)
    dj = cs.tpch_join_data(sf=0.002, seed=6)
    m, b, wants = cs.types_inputs("cpu", d19, dj, cs.q3_types_data(dj))
    jb = {"lines": jax_batch(b["lines"]),
          "q3": {k: jax_batch(v) for k, v in b["q3"].items()}}
    return m, b, jb, wants


@pytest.mark.parametrize("label", ["P17", "P18", "P19"])
def test_tpch_on_true_types_matches_jax_and_the_oracle(inputs, label):
    m, b, jb, wants = inputs
    rows = cs.types_dfs(m, "cpu", b)[label].collect()
    assert rows == wants[label]
    if label == "P19":
        jdf = cs.q3_types_df(JAX, JAX.session.TpuSession(cs.P19_CONF),
                             jb["q3"])
    else:
        build = cs.q1_types_df if label == "P17" else cs.q6_types_df
        jdf = build(JAX, JAX.session.TpuSession(), jb["lines"])
    assert jdf.collect() == rows


def test_the_decimal_types_of_the_results(inputs):
    m, b, _, _ = inputs
    dfs = cs.types_dfs(m, "cpu", b)
    assert [repr(f.data_type) for f in dfs["P17"].schema.fields][2:] == [
        "decimal(22,2)", "decimal(22,2)", "decimal(36,4)", "bigint"]
    assert repr(dfs["P18"].schema.fields[0].data_type) == "decimal(35,4)"
    assert repr(dfs["P19"].schema.fields[3].data_type) == "decimal(36,4)"


def test_p20_paths_equal_their_oracles(inputs):
    """P20's sample (threefry rows, casts, rounding, shifts, a fixed
    offset), its sort over 16 partitions and its count by year."""
    m, b, _, wants = inputs
    dfs = cs.types_dfs(m, "cpu", b)
    for label in ("P20 sample", "P20 sort", "P20 year"):
        assert dfs[label].collect() == wants[label], label
    assert 0 < len(wants["P20 sample"]) < b["l20"].num_rows_host
