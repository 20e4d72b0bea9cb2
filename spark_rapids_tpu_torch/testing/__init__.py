"""Test harness the engine ships with — the counterpart of
spark_rapids_tpu/testing/, the analog of the reference's integration-test
toolkit (integration_tests/src/main/python/data_gen.py composable
generators and asserts.py:579 assert_gpu_and_cpu_are_equal*).

The reference's oracle is CPU Spark running the same query; standalone,
the oracle is (a) an explicit Python-semantics evaluation where provided
and (b) cross-config consistency: the same query run on independent engine
tiers (speculative vs exact, fused vs unfused, single-partition vs
mesh-distributed) must agree bit-for-bit / within float tolerance. The
harness runs on the device it is given: `device="cpu"` in the tests, the
card by default.
"""

from .asserts import (  # noqa: F401
    CONFIG_TIERS, assert_consistent_across_configs,
    assert_equal_with_tolerance, assert_rows_equal, collect_with_conf,
)
from .datagen import (  # noqa: F401
    BooleanGen, ByteGen, DataGen, DateGen, DecimalGen, DoubleGen, FloatGen,
    IntegerGen, LongGen, RepeatSeqGen, SetValuesGen, ShortGen, StringGen,
    TimestampGen, gen_df, gen_pydict,
)
