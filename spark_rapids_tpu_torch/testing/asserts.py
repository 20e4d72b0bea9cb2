"""Equality harness — the counterpart of spark_rapids_tpu/testing/asserts.py
(reference integration_tests/src/main/python/asserts.py:579
assert_gpu_and_cpu_are_equal_collect and friends).

The reference's oracle is CPU Spark executing the same query. Standalone,
correctness is established two ways:

  * `assert_rows_equal(got, expected)` against an explicit Python-semantics
    oracle (exact row values, NaN equal to NaN, with a float tolerance for
    accumulation-order differences);
  * `assert_consistent_across_configs(build)` runs the same logical query
    on independent engine tiers — speculative vs exact, fused vs unfused,
    single-partition vs mesh-distributed — and requires them all to agree.
    A bug must hit every tier identically to slip through.

Every run is on an explicit device: `device=None` is the port's default
(the card; without one the session raises), `device="cpu"` the tests'.
The mesh tiers run over `mesh` when one is given (for example four shards
of one card, `Mesh([torch.device("cuda", 0)] * 4)`), else over
`mesh_devices` shards: CPU shards on the CPU, the first cards on CUDA.
Fewer cards than asked raise; no tier is skipped silently.
"""

from __future__ import annotations

import math
from decimal import Decimal
from typing import Callable, Dict, List, Optional, Sequence

#: engine tiers that must agree on every query (cross-oracle matrix)
CONFIG_TIERS: List[Dict] = [
    {},  # default: speculative masked-bucket + whole-stage fusion
    {"spark.rapids.tpu.agg.speculative.enabled": False},
    {"spark.rapids.tpu.agg.speculative.enabled": False,
     "spark.rapids.tpu.fusion.enabled": False},
]

#: the exact tier the mesh runs beside its default one
_EXACT = {"spark.rapids.tpu.agg.speculative.enabled": False}


def collect_with_conf(build: Callable, conf: Optional[Dict] = None,
                      mesh_devices: Optional[int] = None, device=None,
                      mesh=None) -> List[tuple]:
    """Run `build(session) -> DataFrame` under a fresh session on `device`
    (over `mesh` or `mesh_devices` shards when given) and collect."""
    from ..api.session import TpuSession
    sess = TpuSession(dict(conf or {}), device=device,
                      mesh_devices=mesh_devices, mesh=mesh)
    return build(sess).collect()


def _value_equal(a, b, rel_tol: float) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, float) or isinstance(b, float):
        fa, fb = float(a), float(b)
        if math.isnan(fa) or math.isnan(fb):
            return math.isnan(fa) and math.isnan(fb)
        if math.isinf(fa) or math.isinf(fb):
            return fa == fb
        return math.isclose(fa, fb, rel_tol=rel_tol, abs_tol=rel_tol)
    if isinstance(a, Decimal) or isinstance(b, Decimal):
        return Decimal(a) == Decimal(b)
    return a == b


def _sort_key(row: tuple):
    out = []
    for v in row:
        if v is None:
            out.append((2, ""))
        elif isinstance(v, float) and math.isnan(v):
            out.append((1, ""))
        else:
            out.append((0, str(v)))
    return out


def assert_rows_equal(got: Sequence[tuple], expected: Sequence[tuple],
                      rel_tol: float = 1e-9, ordered: bool = False):
    """Row-set equality with Spark-style float handling (NaN equals NaN;
    tolerance absorbs accumulation-order float differences)."""
    assert len(got) == len(expected), \
        f"row count {len(got)} != {len(expected)}\n" \
        f"got={list(got)[:10]}\nexpected={list(expected)[:10]}"
    g = list(got) if ordered else sorted(got, key=_sort_key)
    e = list(expected) if ordered else sorted(expected, key=_sort_key)
    for i, (rg, re_) in enumerate(zip(g, e)):
        assert len(rg) == len(re_), f"row {i} arity {rg} vs {re_}"
        for j, (a, b) in enumerate(zip(rg, re_)):
            assert _value_equal(a, b, rel_tol), \
                f"row {i} col {j}: {a!r} != {b!r}\n got: {rg}\n exp: {re_}"


def assert_equal_with_tolerance(got, expected, rel_tol: float = 1e-9):
    assert_rows_equal(got, expected, rel_tol=rel_tol)


def _mesh_shards(mesh_devices: Optional[int], device, mesh) -> Optional[int]:
    """How many shards the mesh tiers run over (None: no mesh tiers).
    Raises where the mesh cannot be built: fewer cards than asked."""
    if mesh is not None:
        return mesh.devices.size
    if not mesh_devices:
        return None
    import torch
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cpu":
        return mesh_devices
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < mesh_devices:
        raise RuntimeError(
            f"the mesh tiers need {mesh_devices} cards, have {have}: pass "
            f"mesh= (for example several shards of one card) or "
            f"mesh_devices=None to run without them")
    return mesh_devices


def assert_consistent_across_configs(build: Callable,
                                     mesh_devices: Optional[int] = 8,
                                     rel_tol: float = 1e-6,
                                     expected: Optional[Sequence] = None,
                                     device=None, mesh=None):
    """Run `build(session) -> DataFrame` on every engine tier of `device`,
    and the mesh-distributed plan over `mesh` or `mesh_devices` shards
    (default and exact tiers), and assert all results agree; optionally
    also against an explicit oracle. Returns the default tier's rows."""
    shards = _mesh_shards(mesh_devices, device, mesh)
    results = [(repr(conf), collect_with_conf(build, conf, device=device))
               for conf in CONFIG_TIERS]
    if shards is not None:
        over = dict(device=device, mesh=mesh,
                    mesh_devices=None if mesh is not None else shards)
        results.append((f"mesh[{shards}]",
                        collect_with_conf(build, **over)))
        results.append((f"mesh[{shards}]+exact",
                        collect_with_conf(build, _EXACT, **over)))
    base_name, base = results[0]
    for name, rows in results[1:]:
        try:
            assert_rows_equal(rows, base, rel_tol=rel_tol)
        except AssertionError as ex:
            raise AssertionError(
                f"tier {name} disagrees with {base_name}: {ex}") from ex
    if expected is not None:
        assert_rows_equal(base, list(expected), rel_tol=rel_tol)
    return base
