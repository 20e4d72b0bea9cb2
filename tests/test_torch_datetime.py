"""The port's dates and timestamps (expr/datetimeexprs.py,
ops/datetime_ops.py, ops/timezone.py, ops/rebase.py) and its timestamp
literals against the JAX package's, on the CPU.

Field extraction, date arithmetic, add_months, last_day and trunc over
dates and timestamps from a numpy seed (before 1970, leap days, month
ends); from_utc_timestamp and to_utc_timestamp in a named zone with DST
(the host's tzdata) and at fixed offsets; the Julian rebase tables; and
DATE and TIMESTAMP literals. Every value matches bit for bit. The
functions run through the session as well.
"""

import datetime
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from spark_rapids_tpu.expr import core as jcore
from spark_rapids_tpu.expr import datetimeexprs as jdt
from spark_rapids_tpu.ops import rebase as jrebase
from spark_rapids_tpu import types as jt

from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.api import functions as tF
from spark_rapids_tpu_torch.api import session as tsession
from spark_rapids_tpu_torch.expr import core as tcore
from spark_rapids_tpu_torch.expr import datetimeexprs as tdt
from spark_rapids_tpu_torch.ops import rebase as trebase
from spark_rapids_tpu_torch.ops import timezone as ttz
from spark_rapids_tpu_torch.plan.overrides import PlanNotSupported

import jax.numpy as jnp

from test_torch_encoded import both_batch
from test_torch_jax_ref import jax_aliases
from test_torch_planner import active_confs

JAX = SimpleNamespace(core=jcore, dt=jdt, t=jt)
TORCH = SimpleNamespace(core=tcore, dt=tdt, t=tt)
N = 1024
DAY_US = 86_400_000_000


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases(), active_confs():
        yield


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(3)
    days = rng.integers(-200000, 200000, N).astype(np.int32)
    days[:6] = [0, -1, 11016, 11017, 10956, -141427]   # 2000-02-29 etc.
    ts = rng.integers(-4 * 10**18 // 1000, 4 * 10**18 // 1000, N)
    ts[:4] = [0, -1, 1_710_054_000_000_000, 1_699_164_000_000_000]
    cols = {
        "d": (days, "DATE", rng.random(N) > 0.05),
        "e": (rng.integers(-9000, 20000, N).astype(np.int32), "DATE",
              rng.random(N) > 0.05),
        "ts": (ts.astype(np.int64), "TIMESTAMP", rng.random(N) > 0.05),
        "n": (rng.integers(-400, 400, N).astype(np.int32), "INT",
              rng.random(N) > 0.05),
    }
    return both_batch(cols, N)


def _pair(batches, build):
    return [m.core.resolve(build(m), b.schema).columnar_eval(b)
            for m, b in zip((JAX, TORCH), batches)]


def _exact(j, t):
    np.testing.assert_array_equal(t.validity.numpy(), np.asarray(j.validity))
    np.testing.assert_array_equal(t.data.numpy(),
                                  np.asarray(j.data).astype(t.data.numpy()
                                                            .dtype))


@pytest.mark.parametrize("name", ["Year", "Month", "DayOfMonth",
                                  "DayOfWeek", "DayOfYear", "Quarter",
                                  "LastDay"])
@pytest.mark.parametrize("src", ["d", "ts"])
def test_date_fields_match_jax(batches, name, src):
    _exact(*_pair(batches, lambda m: getattr(m.dt, name)(m.core.col(src))))


@pytest.mark.parametrize("name", ["Hour", "Minute", "Second"])
def test_time_fields_match_jax(batches, name):
    _exact(*_pair(batches, lambda m: getattr(m.dt, name)(m.core.col("ts"))))


@pytest.mark.parametrize("case", ["add", "sub", "diff", "months",
                                  "trunc year", "trunc quarter",
                                  "trunc month", "trunc week"])
def test_date_arithmetic_matches_jax(batches, case):
    def build(m):
        c, d = m.core.col, m.dt
        if case == "add":
            return d.DateAdd(c("d"), c("n"))
        if case == "sub":
            return d.DateAdd(c("d"), c("n"), negate=True)
        if case == "diff":
            return d.DateDiff(c("d"), c("e"))
        if case == "months":
            return d.AddMonths(c("d"), c("n"))
        return d.TruncDate(c("d"), case.split()[1])
    _exact(*_pair(batches, build))


@pytest.mark.parametrize("tz", ["America/New_York", "Asia/Kolkata",
                                "Europe/London", "+05:30", "-08:00",
                                "UTC+3", "UTC"])
@pytest.mark.parametrize("cls", ["FromUTCTimestamp", "ToUTCTimestamp"])
def test_time_zones_match_jax(batches, tz, cls):
    """A named zone reads the host's tzdata through the port's own TZif
    parser; DST gaps and overlaps resolve as in the JAX package."""
    _exact(*_pair(batches, lambda m: getattr(m.dt, cls)(m.core.col("ts"),
                                                          tz)))


def test_zone_tables_match_jax():
    from spark_rapids_tpu.ops import timezone as jtz
    for tz in ("America/New_York", "Australia/Lord_Howe", "+01:00"):
        for a, b in zip(jtz.timezone_db().tables(tz),
                        ttz.timezone_db().tables(tz)):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_unknown_zone_is_tagged_off(batches):
    tb = batches[1]
    df = tsession.TpuSession(device="cpu").from_batches([tb], tb.schema)
    q = df.select(tF.from_utc_timestamp("ts", "Mars/Olympus").alias("x"))
    with pytest.raises(PlanNotSupported, match="timezone: unknown timezone"):
        q.collect()


def test_rebase_matches_jax():
    rng = np.random.default_rng(8)
    days = rng.integers(-800000, 10000, 4000).astype(np.int64)
    days[:4] = [-141427, -141428, -141438, 0]
    micros = days * DAY_US + rng.integers(0, DAY_US, 4000)
    t_days, t_micros = torch.from_numpy(days), torch.from_numpy(micros)
    for jf, tf, x, tx in (
            (jrebase.rebase_julian_to_gregorian_days,
             trebase.rebase_julian_to_gregorian_days, days, t_days),
            (jrebase.rebase_gregorian_to_julian_days,
             trebase.rebase_gregorian_to_julian_days, days, t_days),
            (jrebase.rebase_julian_to_gregorian_micros,
             trebase.rebase_julian_to_gregorian_micros, micros, t_micros),
            (jrebase.rebase_gregorian_to_julian_micros,
             trebase.rebase_gregorian_to_julian_micros, micros, t_micros)):
        np.testing.assert_array_equal(tf(tx).numpy(),
                                      np.asarray(jf(jnp.asarray(x))))


def test_timestamp_and_date_literals():
    """lit(datetime) is a TIMESTAMP literal (UTC micros; a naive one taken
    as UTC) and lit(date) a DATE literal; Literal(micros, TIMESTAMP)
    evaluates as the JAX package's does (whose lit infers neither)."""
    when = datetime.datetime(1995, 3, 15, 12, 30, 1, 250)
    aware = datetime.datetime(1995, 3, 15, 14, 30, 1, 250,
                              tzinfo=datetime.timezone(
                                  datetime.timedelta(hours=2)))
    micros = (when - datetime.datetime(1970, 1, 1)) \
        // datetime.timedelta(microseconds=1)
    for v in (when, aware):
        e = tcore.lit(v)
        assert e.data_type == tt.TIMESTAMP and e.value == micros
    d = tcore.lit(datetime.date(1998, 12, 1))
    assert d.data_type == tt.DATE and d.value == 10561
    jb, tb = both_batch({"k": (np.arange(5, dtype=np.int32), "INT", None)},
                        5)
    j = jcore.Literal(micros, jt.TIMESTAMP).columnar_eval(jb)
    t = tcore.lit(when).columnar_eval(tb)
    _exact(j, t)
    h = tcore.resolve(tdt.Hour(tcore.lit(when)), tb.schema)
    assert h.columnar_eval(tb).to_pylist(1) == [12]


def test_functions_through_the_session(batches):
    jb, tb = batches
    df = tsession.TpuSession(device="cpu").from_batches([tb], tb.schema)
    rows = df.select(
        tF.year("d").alias("y"), tF.month("d").alias("m"),
        tF.dayofmonth("d").alias("dd"), tF.quarter("d").alias("q"),
        tF.date_add("d", 3).alias("a"), tF.date_sub("d", 3).alias("s"),
        tF.datediff("d", "e").alias("df"), tF.add_months("d", 1).alias("am"),
        tF.last_day("d").alias("ld"), tF.trunc("d", "month").alias("t"),
        tF.dayofweek("d").alias("w"), tF.dayofyear("d").alias("doy"),
        tF.hour("ts").alias("h"), tF.minute("ts").alias("mi"),
        tF.second("ts").alias("se"),
        tF.to_utc_timestamp("ts", "+05:30").alias("u"),
        tF.from_utc_timestamp("ts", "+05:30").alias("f")).collect()
    epoch = datetime.date(1970, 1, 1)
    for r, d, dv, ts, tv in zip(rows, tb.columns[0].to_pylist(N),
                                tb.columns[0].validity.numpy(),
                                tb.columns[2].to_pylist(N),
                                tb.columns[2].validity.numpy()):
        if dv and 1 <= (epoch + datetime.timedelta(days=d)).year:
            day = epoch + datetime.timedelta(days=d)
            assert r[:4] == (day.year, day.month, day.day,
                             (day.month - 1) // 3 + 1)
            assert (r[4], r[5]) == (d + 3, d - 3)
        if tv:
            sec = ts // 10**6
            assert r[12:15] == ((sec // 3600) % 24, (sec // 60) % 60,
                                sec % 60)
            off = (5 * 3600 + 1800) * 10**6
            assert (r[15], r[16]) == (ts - off, ts + off)
