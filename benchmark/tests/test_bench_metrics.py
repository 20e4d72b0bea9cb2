"""The metric arithmetic on synthetic inputs: the rate over whole queries,
the mean time of each query, and the idle share and gaps of a synthetic
trace."""

from types import SimpleNamespace

import pytest

from harness import bench
from harness.trace import Trace, innermost


def obs_of(seconds, scanned, window_s, ok=None, names=None):
    obs = bench.Observation()
    obs.queries = [SimpleNamespace(name=names[i] if names else "q",
                                   params={}, seconds=s, scanned=n,
                                   ok=True if ok is None else ok[i],
                                   rows=[])
                   for i, (s, n) in enumerate(zip(seconds, scanned))]
    obs.window_s = window_s
    return obs


def read(name, obs):
    return bench.metric_module(name).read(obs, name)


@pytest.mark.parametrize("name", ["rows_per_s", "rows_per_s.join",
                                  "rows_per_s.pricing"])
def test_rate_counts_the_rows_of_completed_queries_over_the_window(name):
    obs = obs_of([1.0, 2.0, 1.0], [100, 300, 50], 4.0, [True, True, False])
    assert read(name, obs) == pytest.approx(100.0)
    assert read(name, obs_of([], [], 0.0)) is None


def test_percentile_interpolates_between_ranks():
    xs = list(range(1, 101))
    assert bench.percentile(xs, 90) == pytest.approx(90.1)
    assert bench.percentile([5.0], 90) == 5.0


def test_query_ms_is_the_mean_of_that_query_over_the_window():
    obs = obs_of([0.1, 3.0, 0.3, 1.0, 9.0], [1] * 5, 14.0,
                 [True, True, True, True, False],
                 ["q19", "q3", "q19", "q21", "q21"])
    assert read("query_ms.q19", obs) == pytest.approx(200.0)
    assert read("query_ms.q3", obs) == pytest.approx(3000.0)
    assert read("query_ms.q21", obs) == pytest.approx(1000.0)
    assert read("query_ms.q4", obs) is None


def test_a_split_name_finds_its_base_reader():
    for name in ("host_syncs_per_query.join", "device_idle_pct.pricing",
                 "query_ms.q6", "torch_kernel_ms.join"):
        mod = bench.metric_module(name)
        assert mod.__file__.endswith(name.split(".")[0] + ".py"), name


def test_per_query_counts_divide_by_completed_queries():
    obs = obs_of([1.0] * 4, [1] * 4, 4.0)
    obs.state["host_syncs"] = 10
    obs.state["eager_steps"] = 6
    obs.state["plan_ms"] = 8_000_000
    obs.state["graph_captures"] = 1
    assert read("host_syncs_per_query", obs) == 2.5
    assert read("eager_steps_per_query.join", obs) == 1.5
    assert read("plan_ms", obs) == pytest.approx(2.0)
    assert read("graph_captures_per_query.join", obs) == 0.25


def synthetic_trace():
    # window [0, 100) ns; kernels overlap in [10, 30), one copy [50, 60)
    ops = [("m3_rows", 10, 20, "kernel"), ("aten_sort", 15, 30, "kernel"),
           ("Memcpy DtoH", 50, 60, "gpu_memcpy"),
           ("outside", 200, 300, "kernel")]
    host = [("bench.window", 0, 100, "user_annotation"),
            ("HashJoinExec", 0, 45, "user_annotation"),
            ("aten::nonzero", 30, 45, "cpu_op"),
            ("SortExec", 60, 100, "user_annotation")]
    return Trace(ops, host, (0, 100))


def test_busy_union_and_idle_share():
    t = synthetic_trace()
    assert t.busy_intervals() == [(10, 30), (50, 60)]
    assert t.busy_s() == pytest.approx(30e-9)
    obs = bench.Observation()
    obs.trace = t
    assert read("device_idle_pct", obs) == pytest.approx(70.0)
    obs.queries = obs_of([1.0, 1.0], [1, 1], 1.0).queries
    assert read("launches_per_query", obs) == 1.0
    assert read("own_kernel_ms", obs) == pytest.approx(10e-6 / 2)
    assert read("torch_kernel_ms", obs) == pytest.approx(15e-6 / 2)


def test_idle_gaps_named_by_the_host():
    t = synthetic_trace()
    assert t.idle_gaps() == [(0, 10), (30, 50), (60, 100)]
    named = t.idle_by_host()
    assert named == {"HashJoinExec / -": 10e-9,
                     "HashJoinExec / aten::nonzero": 20e-9,
                     "SortExec / -": 40e-9}


def test_breakdown_names_are_short_and_merged():
    from harness.trace import top
    long_a = "void k<" + "a" * 200 + ">(int)"
    long_b = "void k<" + "a" * 200 + ">(long)"
    assert top({long_a: 1.0, long_b: 2.0, "m": 0.5}, short=True) == \
        [["k<" + "a" * 95 + "...", 3.0], ["m", 0.5]]


def test_innermost_range_at_each_point():
    ranges = [("a", 0, 100), ("b", 10, 20), ("c", 30, 40), ("d", 32, 35)]
    assert innermost([5, 15, 25, 33, 38, 150], ranges) == \
        ["a", "b", "a", "d", "c", None]


def test_no_device_work_reads_nothing():
    obs = bench.Observation()
    obs.trace = Trace([], [], (0, 100))
    obs.queries = obs_of([1.0], [1], 1.0).queries
    for name in ("device_idle_pct", "own_kernel_ms", "torch_kernel_ms",
                 "launches_per_query"):
        assert read(name, obs) is None, name


def test_bound_takes_the_larger_of_bytes_and_operations():
    from harness.roofline import bound
    ms, what = bound(3.35e9, 1.0)
    assert ms == pytest.approx(1.0) and what == "bytes"
    ms, what = bound(1.0, 67e9)
    assert ms == pytest.approx(1.0) and what == "operations"
