"""faults.py against the JAX package's: the fault decisions over a grid
of (seed, point, task, key, call index) and `parse_faults` are exact;
the point names are the JAX package's, the mesh lane's
`shuffle.ici_exchange` among them. Port-only: the taxonomy maps
`torch.OutOfMemoryError` to "oom", the injected kinds and integrity
failures to "task", and a CUDA runtime error or a kernel build failure
to "fatal" (ROADMAP C)."""

import errno
import itertools

import pytest
import torch

from spark_rapids_tpu import faults as jfaults
from spark_rapids_tpu.memory import retry as jretry

from spark_rapids_tpu_torch import faults as tfaults
from spark_rapids_tpu_torch.memory import catalog as tcatalog
from spark_rapids_tpu_torch.memory import retry as tretry

from test_torch_jax_ref import jax_aliases

#: the JAX package's points whose seams wait for their items: none since
#: the mesh lane's `shuffle.ici_exchange` landed
NOT_PORTED = {}


@pytest.fixture(scope="module", autouse=True)
def _aliases():
    with jax_aliases():
        yield
    jfaults.install(None)
    tfaults.install(None)


def test_fault_points_are_the_jax_packages_less_the_unported():
    assert set(tfaults.FAULT_POINTS) == set(jfaults.FAULT_POINTS) \
        - set(NOT_PORTED)
    assert tfaults.KINDS == jfaults.KINDS
    assert "shuffle.ici_exchange" in tfaults.FAULT_POINTS
    assert tfaults.parse_faults("shuffle.ici_exchange:prob=1,kind=device")
    for point, item in NOT_PORTED.items():
        with pytest.raises(NotImplementedError, match=item):
            tfaults.parse_faults(f"{point}:prob=1,kind=io")


SPECS = [
    "device.dispatch:prob=0.3,seed=7,kind=device",
    "spill.disk_write:prob=0.5,seed=1,kind=corrupt,max=2",
    "shuffle.fetch:prob=0.25,seed=3,kind=io;shuffle.decode:prob=0.4,"
    "seed=11,kind=corrupt,max=3",
    "pipeline.produce:prob=1,seed=2,kind=delay,ms=1",
    " io.multifile_read : prob=0.9 , seed=5 , kind=io ; ",
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_faults_matches_jax(spec):
    j, t = jfaults.parse_faults(spec), tfaults.parse_faults(spec)
    assert set(t.specs) == set(j.specs)
    for point, s in t.specs.items():
        r = j.specs[point]
        assert (s.prob, s.seed, s.kind, s.max_injections, s.delay_ms) == \
            (r.prob, r.seed, r.kind, r.max_injections, r.delay_ms)
    assert tfaults.parse_faults("") is None
    assert jfaults.parse_faults("") is None


@pytest.mark.parametrize("bad", [
    "no.such.point:prob=1", "device.dispatch:kind=melt",
    "device.dispatch:color=red", "pipeline.produce:kind=delay"])
def test_bad_specs_raise_in_both(bad):
    with pytest.raises(ValueError):
        jfaults.parse_faults(bad)
    with pytest.raises(ValueError):
        tfaults.parse_faults(bad)


def _decisions(faults_mod, retry_mod, spec, tasks, keys, calls,
               corruptible):
    plan = faults_mod.parse_faults(spec)
    out = []
    try:
        for task in tasks:
            retry_mod.register_task(task)
            for key, _ in itertools.product(keys, range(calls)):
                for point in sorted(plan.specs):
                    out.append(plan.decide(point, corruptible, key=key))
    finally:
        retry_mod.unregister_task()
    return out, plan.stats()


@pytest.mark.parametrize("seed", [0, 1, 17, 2024])
@pytest.mark.parametrize("corruptible", [True, False])
def test_fault_decisions_match_jax_on_a_grid(seed, corruptible):
    spec = (f"device.dispatch:prob=0.35,seed={seed},kind=device;"
            f"spill.disk_write:prob=0.5,seed={seed + 1},kind=corrupt,max=9;"
            f"shuffle.fetch:prob=0.2,seed={seed},kind=io")
    args = (spec, [0, 3, 41], [None, "a", "spill:12", "p3:7"], 6,
            corruptible)
    assert _decisions(tfaults, tretry, *args) == \
        _decisions(jfaults, jretry, *args)


def test_apply_raises_and_corrupts_as_jax():
    data = bytes(range(200))
    for kind, exc in (("io", OSError), ("device", RuntimeError)):
        for m in (jfaults, tfaults):
            plan = m.parse_faults(f"shuffle.decode:prob=1,kind={kind}")
            with pytest.raises(exc):
                plan.apply("shuffle.decode", data)
    j = jfaults.parse_faults("shuffle.decode:prob=1,kind=corrupt")
    t = tfaults.parse_faults("shuffle.decode:prob=1,kind=corrupt")
    assert t.apply("shuffle.decode", data) == j.apply("shuffle.decode", data)
    assert t.apply("shuffle.decode", data) != data
    assert tfaults.backoff_s(3, 100, 5000, "k") == \
        jfaults.backoff_s(3, 100, 5000, "k")
    assert tfaults.uniform_spec(0.1, 4) == ";".join(
        p for p in jfaults.uniform_spec(0.1, 4).split(";")
        if p.split(":")[0] not in NOT_PORTED)


def test_install_configure_and_the_fast_path():
    from spark_rapids_tpu_torch.config import RapidsConf
    assert tfaults.active_plan() is None
    tfaults.check("device.dispatch")  # off: no effect
    spec = "device.dispatch:prob=1,seed=1,kind=device,max=1"
    conf = RapidsConf({"spark.rapids.tpu.test.faults": spec})
    plan = tfaults.configure(conf)
    assert tfaults.configure(conf) is plan  # same run: the plan stays
    assert tfaults.configure(RapidsConf()) is plan  # unset: untouched
    with pytest.raises(tfaults.InjectedDeviceError):
        tfaults.check("device.dispatch")
    tfaults.check("device.dispatch")  # max=1 spent
    assert tfaults.stats() == {"device.dispatch": 1}
    tfaults.configure(RapidsConf({"spark.rapids.tpu.test.faults": ""}))
    assert tfaults.active_plan() is None


@pytest.mark.parametrize("exc, kind", [
    (torch.OutOfMemoryError("CUDA out of memory"), "oom"),
    (tretry.TpuRetryOOM("budget"), "oom"),
    (tretry.TpuSplitAndRetryOOM("split"), "oom"),
    (tfaults.InjectedDeviceError("device.dispatch"), "task"),
    (tfaults.InjectedIOError("shuffle.fetch"), "task"),
    (tfaults.IntegrityError("crc"), "task"),
    (tcatalog.SpillFileCorruption("spill file checksum mismatch"), "task"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "fatal"),
    (RuntimeError("row_gather kernel launch failed: CUDA error 700"),
     "fatal"),
    (RuntimeError("nvcc failed:\n--- k.log\nerror"), "fatal"),
    (OSError(errno.EIO, "a real disk error"), "fatal"),
    (ValueError("a bug"), "fatal"),
])
def test_classify_the_ports_errors(exc, kind):
    assert tfaults.classify(exc) == kind
