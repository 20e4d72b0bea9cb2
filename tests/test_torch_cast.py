"""The port's casts (expr/cast.py, ops/cast_strings.py) and format_number
against the JAX package's, on the CPU.

Numeric, boolean, date, timestamp and DECIMAL(p<=18) casts, and strings
to and from them, over the same numpy inputs (nulls, NaN, infinities,
out-of-range values, malformed strings and whitespace): data, validity
and rendered strings match bit for bit. String to double follows the JAX
package's digit algorithm; the two agree bit for bit except where XLA's
pow(10, k) is not correctly rounded (k = 23 and 210) or flushes a
subnormal to zero, where the port's correctly rounded power of ten may
differ by one ulp (the bound held below). Casts without a device kernel
are tagged off at plan time, as in the JAX package.

The JAX package's string rendering runs eagerly and costs seconds a
case, so a rendering whose result Python states exactly (a decimal, a
boolean, a date, format_number of an integer) is held to that oracle,
and one case of each kind is crossed with the JAX package.
"""

import re
from types import SimpleNamespace

import numpy as np
import pytest

from spark_rapids_tpu import types as jt
from spark_rapids_tpu.api import session as jsession
from spark_rapids_tpu.expr import cast as jcast
from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.expr import stringexprs as jstr

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.api import functions as tF
from spark_rapids_tpu_torch.api import session as tsession
from spark_rapids_tpu_torch.expr import cast as tcast
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.expr import stringexprs as tstr
from spark_rapids_tpu_torch.plan.overrides import PlanNotSupported

from test_torch_encoded import both_batch
from test_torch_jax_ref import jax_aliases
from test_torch_planner import active_confs

JAX = SimpleNamespace(t=jt, core=jcore, cast=jcast, s=jstr,
                      session=jsession)
TORCH = SimpleNamespace(t=tt, core=tcore, cast=tcast, s=tstr,
                        session=tsession)
N = 256


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs():
        yield


STRINGS = ["0", "42", "-17", "+8", "  123  ", "\t-5\n", "", " ", "abc",
           "1.5", "9223372036854775807", "-9223372036854775808",
           "9223372036854775808", "2147483648", "-129", "127", "1e3", "-",
           "+", "3.14159", "-0.0", ".5", "5.", "1e10", "1E-5", "2.5e+3",
           "1e", "e5", "1.2.3", "NaN", "nan", "-Infinity", "inf", "INF",
           "Infinity", "1e23", "123456789012345678901234567890",
           "0.000001234", "7e-300", "true", "FALSE", "Yes", "n", "1", "t",
           "2020-02-29", "2021-02-29", "1998-12-01", "1998-12", "1998",
           "2000-1-5", "2000-01-05T10:00:00", "2000-01-05 x", "2000-13-01",
           "12345-01-01", "  1995-03-15  ", "1995/03/15"]


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(7)
    strs = (STRINGS * (N // len(STRINGS) + 1))[:N]
    d = rng.random(N) * 2e10 - 1e10
    d[:8] = [np.nan, np.inf, -np.inf, 0.5, -0.5, 2.5, 1e19, -1e19]
    f = (rng.random(N) * 4e9 - 2e9).astype(np.float32)
    f[:4] = [np.nan, np.inf, 3e9, -2147483648.0]
    cols = {
        "s": (strs, "STRING", rng.random(N) > 0.05),
        "i": (rng.integers(-2**31, 2**31, N).astype(np.int32), "INT",
              rng.random(N) > 0.1),
        "l": (rng.integers(-2**63, 2**63 - 1, N, dtype=np.int64), "LONG",
              rng.random(N) > 0.1),
        "d": (d, "DOUBLE", rng.random(N) > 0.1),
        "f": (f, "FLOAT", rng.random(N) > 0.1),
        "b": (rng.random(N) > 0.5, "BOOLEAN", rng.random(N) > 0.1),
        "dt": (rng.integers(-30000, 40000, N).astype(np.int32), "DATE",
               rng.random(N) > 0.1),
        "ts": (rng.integers(-2**50, 2**50, N).astype(np.int64), "TIMESTAMP",
               rng.random(N) > 0.1),
    }
    return both_batch(cols, N)


def _eval(m, batch, expr):
    return m.core.resolve(expr, batch.schema).columnar_eval(batch)


def _types(m):
    t = m.t
    return {"BYTE": t.BYTE, "SHORT": t.SHORT, "INT": t.INT, "LONG": t.LONG,
            "FLOAT": t.FLOAT, "DOUBLE": t.DOUBLE, "BOOLEAN": t.BOOLEAN,
            "DATE": t.DATE, "TIMESTAMP": t.TIMESTAMP, "STRING": t.STRING,
            "DEC": t.DecimalType(12, 2), "DEC0": t.DecimalType(18, 0),
            "DEC5": t.DecimalType(6, 5)}


def _pair(batches, src, dst, expr=None):
    out = []
    for m, b in zip((JAX, TORCH), batches):
        e = m.cast.Cast(m.core.col(src) if expr is None else expr(m),
                        _types(m)[dst])
        out.append(_eval(m, b, e))
    return out


def _same(j, t, n=N):
    """Validity equal, and the data bit for bit (floats by their bits)."""
    np.testing.assert_array_equal(t.validity.numpy()[:n],
                                  np.asarray(j.validity)[:n])
    if t.data is not None and t.data.dtype.is_floating_point:
        jd = np.asarray(j.data)[:n]
        np.testing.assert_array_equal(
            t.data.numpy()[:n].view(f"i{jd.itemsize}"),
            jd.view(f"i{jd.itemsize}"))
    else:
        assert t.to_pylist(n) == j.to_pylist(n)


NUMERIC = [("i", d) for d in ("BYTE", "SHORT", "LONG", "FLOAT", "DOUBLE",
                              "BOOLEAN", "DEC", "TIMESTAMP")] + \
    [("l", d) for d in ("INT", "SHORT", "DOUBLE", "DEC0")] + \
    [("d", d) for d in ("INT", "LONG", "BYTE", "FLOAT", "BOOLEAN", "DEC",
                        "DEC5")] + \
    [("f", d) for d in ("INT", "LONG", "DOUBLE")] + \
    [("b", d) for d in ("INT", "DOUBLE", "LONG")] + \
    [("dt", "TIMESTAMP"), ("dt", "INT"), ("ts", "DATE"), ("ts", "LONG")]


@pytest.mark.parametrize("src, dst", NUMERIC)
def test_numeric_and_temporal_casts_match_jax(batches, src, dst):
    _same(*_pair(batches, src, dst))


def _decimal_strings(col, scale):
    """Python's rendering of a DECIMAL column's unscaled values."""
    import decimal
    return [None if v is None else
            format(decimal.Decimal(v).scaleb(-scale), "f")
            for v in col.to_pylist(N)]


@pytest.mark.parametrize("dst", ["INT", "LONG", "DOUBLE", "FLOAT", "DEC0",
                                 "DEC5", "BOOLEAN", "STRING"])
def test_decimal_casts_match_jax(batches, dst):
    """A DECIMAL(12, 2) made from the doubles (HALF_UP, overflow to
    null), then cast on; to STRING against Python's Decimal (the decimal
    casts to strings are crossed with the JAX package through that
    decimal's own values, `test_numeric_and_temporal_casts_match_jax`)."""
    def src(m):
        return m.cast.Cast(m.core.col("d"), _types(m)["DEC"])
    if dst == "STRING":
        got = _eval(TORCH, batches[1], TORCH.cast.Cast(src(TORCH), tt.STRING))
        dec = _eval(TORCH, batches[1], src(TORCH))
        assert got.to_pylist(N) == _decimal_strings(dec, 2)
        return
    _same(*_pair(batches, None, dst, src))


def _rendered(v, src):
    import datetime
    if v is None:
        return None
    if src == "b":
        return "true" if v else "false"
    if src == "dt":
        return (datetime.date(1970, 1, 1)
                + datetime.timedelta(days=v)).isoformat()
    return str(v)


@pytest.mark.parametrize("src", ["i", "l", "b", "dt"])
def test_values_to_string_match_jax(batches, src):
    """The longs crossed with the JAX package; every kind against
    Python's rendering (booleans as Spark's true/false, dates as ISO
    8601)."""
    if src == "l":
        _same(*_pair(batches, src, "STRING"))
    tb = batches[1]
    t = _eval(TORCH, tb, TORCH.cast.Cast(tcore.col(src), tt.STRING))
    vals = tb.columns[tb.schema.index_of(src)].to_pylist(N)
    assert t.to_pylist(N) == [_rendered(v, src) for v in vals]


@pytest.mark.parametrize("dst", ["BYTE", "INT", "LONG", "BOOLEAN", "DATE"])
def test_strings_parse_like_jax(batches, dst):
    _same(*_pair(batches, "s", dst))


@pytest.mark.parametrize("dst", ["DOUBLE", "FLOAT"])
def test_strings_to_fractional_within_the_pow_bound(batches, dst):
    """Bit for bit but where XLA's pow(10, k) is off (10^23 here): one
    ulp of the double, none of the float."""
    j, t = _pair(batches, "s", dst)
    np.testing.assert_array_equal(t.validity.numpy(), np.asarray(j.validity))
    strs = batches[1].columns[0].to_pylist(N)
    for i, s in enumerate(strs):
        if s is None or not bool(t.validity[i]):
            continue
        jv, tv = np.asarray(j.data)[i], t.data.numpy()[i]
        if s.strip() in ("1e23",) and dst == "DOUBLE":
            assert abs(int(jv.view(np.int64)) - int(tv.view(np.int64))) <= 1
        else:
            assert jv.tobytes() == tv.tobytes(), (s, jv, tv)


@pytest.mark.parametrize("src, digits", [("i", 0), ("i", 2), ("l", 5),
                                         ("d", 2)])
def test_format_number_matches_jax(batches, src, digits):
    """The long and the double crossed with the JAX package; the ints
    against the exact rendering (grouped digits, then `digits` zeros). A
    long whose value times 10^digits passes the int64 range saturates
    there in both packages (ROADMAP C.5)."""
    tb = batches[1]
    got = _eval(TORCH, tb, tstr.FormatNumber(tcore.col(src), digits))
    if src != "i":
        want = _eval(JAX, batches[0], jstr.FormatNumber(jcore.col(src),
                                                        digits))
        assert got.to_pylist(N) == want.to_pylist(N)
    if src == "i":
        vals = tb.columns[tb.schema.index_of(src)].to_pylist(N)
        assert got.to_pylist(N) == [
            None if v is None else
            f"{v:,}" + ("." + "0" * digits if digits else "") for v in vals]


@pytest.mark.parametrize("src, dst", [("d", "STRING"), ("s", "DEC"),
                                      ("ts", "STRING"), ("s", "TIMESTAMP")])
def test_casts_without_a_kernel_are_tagged_off(batches, src, dst):
    """As in the JAX package: the planner tags them off the device with
    the same reason, rather than failing mid-run. A cast to a string then
    runs on the host row engine (`~`) with the JAX package's rows; a cast
    to a DECIMAL or TIMESTAMP has no host cast either, and the plan is
    refused."""
    tb = batches[1]
    sess = tsession.TpuSession(device="cpu")
    df = sess.from_batches([tb], tb.schema).select(
        tcore.col(src).cast(_types(TORCH)[dst]).alias("c"))
    reason = f"cast {tb.schema[tb.schema.index_of(src)].data_type.simple_name()}" \
        f" -> {_types(TORCH)[dst].simple_name()} has no device kernel"
    jb = batches[0]
    jdf = jsession.TpuSession().from_batches([jb], jb.schema).select(
        jcore.col(src).cast(_types(JAX)[dst]).alias("c"))
    assert reason in jdf.explain() and reason in df.explain()
    if dst == "STRING":
        assert df.explain().startswith("~ ")
        assert jdf.explain().startswith("~ ")
        assert df.collect() == jdf.collect()
        return
    with pytest.raises(PlanNotSupported, match=re.escape(reason)):
        df.collect()


def test_decimal_to_string_renders_like_python(batches):
    """Scale 0 and a scale equal to the precision (leading "0." and
    "-0.0000"), from the longs and the doubles."""
    tb = batches[1]
    for src, dst, scale in (("l", "DEC0", 0), ("d", "DEC5", 5),
                            ("i", "DEC", 2)):
        dec = _eval(TORCH, tb, tcast.Cast(tcore.col(src), _types(TORCH)[dst]))
        t = _eval(TORCH, tb, tcast.Cast(tcast.Cast(
            tcore.col(src), _types(TORCH)[dst]), tt.STRING))
        assert t.to_pylist(N) == _decimal_strings(dec, scale), dst


def test_format_number_through_the_session(batches):
    tb = batches[1]
    df = tsession.TpuSession(device="cpu").from_batches([tb], tb.schema)
    rows = df.select(tF.format_number("i", 2).alias("f")).collect()
    assert [r[0] for r in rows] == [
        None if v is None else f"{v:,.2f}" for v in tb.columns[1].to_pylist(N)]
