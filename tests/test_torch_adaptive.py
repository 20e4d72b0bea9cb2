"""exec/adaptive.py's decisions against the JAX package's on seeded lists:
the skew threshold (the median over the nonzero partitions, the factor
and the floor), the adjacent coalescing of small partitions (excluded
partitions standing alone) and the demotion cap. The reference reads the
skew factor and floor from a conf (a stand-in with its keys here); the
port takes them from its caller, since it accepts only the defaults of
the keys whose exchange decisions wait for ROADMAP A.9."""

import numpy as np
import pytest

from spark_rapids_tpu import config as jconfig
from spark_rapids_tpu.exec import adaptive as jadaptive

from spark_rapids_tpu_torch import config as tconfig
from spark_rapids_tpu_torch.exec import adaptive as tadaptive

from test_torch_jax_ref import jax_aliases


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield


class _Conf:
    """A conf of given values by key, the defaults elsewhere."""

    def __init__(self, values):
        self.values = values

    def get(self, entry):
        return self.values.get(entry.key, entry.default)


def _lists(seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 12))
        v = rng.integers(0, 64 << 20, k)
        v[rng.random(k) < 0.3] = 0      # empty partitions
        if k and rng.random() < 0.3:
            v[rng.integers(0, k)] *= 50  # a hot one
        out.append([int(x) for x in v])
    return out


@pytest.mark.parametrize("factor, floor", [(4.0, 16 << 20), (2.0, 0),
                                           (0.0, 0), (-1.0, 1 << 20),
                                           (8.0, 1 << 30)])
def test_skew_threshold_matches_jax(factor, floor):
    keys = (tconfig.ADAPTIVE_SKEW_FACTOR.key,
            tconfig.ADAPTIVE_SKEW_MIN_BYTES.key)
    assert keys == (jconfig.ADAPTIVE_SKEW_FACTOR.key,
                    jconfig.ADAPTIVE_SKEW_MIN_BYTES.key)
    conf = _Conf(dict(zip(keys, (factor, floor))))
    got = [tadaptive.skew_threshold(b, factor, floor) for b in _lists(1)]
    assert got == [jadaptive.skew_threshold(b, conf) for b in _lists(1)]
    assert any(g is not None for g in got) == (factor > 0)


@pytest.mark.parametrize("target", [0, 1 << 20, 16 << 20, 256 << 20])
def test_coalesce_groups_matches_jax(target):
    rng = np.random.default_rng(2)
    for parts in _lists(3):
        exclude = {int(p) for p in rng.integers(0, 12, 2)}
        for ex in (None, exclude):
            got = tadaptive.coalesce_groups(parts, target, ex)
            assert got == jadaptive.coalesce_groups(parts, target, ex)
            if got is not None:
                assert sum(got, []) == list(range(len(parts)))


@pytest.mark.parametrize("cap", [None, "-1", "1000", str(64 << 20)])
def test_demote_cap_matches_jax(cap):
    """The conf's cap (no workload governor runs in either package
    here)."""
    key = "spark.rapids.tpu.adaptive.autoBroadcastMaxBytes"
    settings = {} if cap is None else {key: cap}
    want = jadaptive.demote_cap(jconfig.RapidsConf(settings))
    assert tadaptive.demote_cap(tconfig.RapidsConf(settings)) == want
    assert tadaptive.auto_broadcast_max(tconfig.RapidsConf(settings)) \
        == jadaptive.auto_broadcast_max(jconfig.RapidsConf(settings))


def test_consult_counts_and_the_decision_table_match_jax():
    """A consult under the conf on counts one; off, none; a demotion
    counts its decision's counter. The table and the counter keys are
    the reference's."""
    assert tadaptive.DECISIONS == jadaptive.DECISIONS
    tadaptive.reset_adaptive()
    jadaptive.reset_adaptive()
    key = "spark.rapids.tpu.adaptive.enabled"
    for m, c in ((tadaptive, tconfig), (jadaptive, jconfig)):
        assert m.consult(c.RapidsConf({}))
        assert not m.consult(c.RapidsConf({key: "false"}))
        m.note_demote("broadcast_demote", op="AdaptiveJoinExec",
                      measured_bytes=2, threshold=1, basis="conf",
                      planned="build_right")
    got, want = tadaptive.counters(), jadaptive.counters()
    assert got == want
    assert got["consults"] == 1 and got["broadcast_demotes"] == 1
