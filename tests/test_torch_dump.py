"""The failure dump of the port (utils/dump.py and TpuExec's hook) on the
CPU, held to the JAX package's:

- dump_batch writes parquet that reads back equal to the batch, and a
  `.meta.json` equal to the JAX package's for the same input;
- dump_on_error writes error.txt, one record per observed batch and a
  repro.py that compiles, names the port and no jax, and loads the
  batches back; without pyarrow a batch's record is the `.FAILED` file;
- an operator failure (a hand-built exec, a planned query with an
  injected device fault, a compiled stage) dumps the failing operator's
  inputs with the real traceback and re-raises the original error;
- with the path empty no batch is retained and nothing is written;
- RapidsConf takes any dumpPath.

Row values and the meta are exact.
"""

import builtins
import glob
import json
import os
from pathlib import Path

import numpy as np
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import config as jconfig
from spark_rapids_tpu import types as jt
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JBatch
from spark_rapids_tpu.utils import dump as jdump

from spark_rapids_tpu_torch import config as tconfig
from spark_rapids_tpu_torch import types as tt
from spark_rapids_tpu_torch.api import functions as F
from spark_rapids_tpu_torch.api.session import TpuSession
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.exec.base import TpuExec
from spark_rapids_tpu_torch.utils import dump as tdump

from test_torch_jax_ref import jax_aliases, one_torch_thread

DUMP = "spark.rapids.sql.debug.dumpPath"


@pytest.fixture(scope="module", autouse=True)
def _env():
    with jax_aliases(), one_torch_thread():
        yield
    tconfig.set_active_conf(tconfig.RapidsConf())
    jconfig.set_active_conf(jconfig.RapidsConf())


def data(seed=0, n=50):
    rng = np.random.default_rng(seed)
    k = [None if rng.random() < 0.2 else int(v)
         for v in rng.integers(-5, 5, n)]
    s = [None if rng.random() < 0.2 else "x" * int(v)
         for v in rng.integers(0, 6, n)]
    d = [float(v) for v in rng.normal(size=n)]
    return {"k": k, "s": s, "d": d}


def schemas():
    return (tt.Schema((tt.StructField("k", tt.LONG),
                       tt.StructField("s", tt.STRING),
                       tt.StructField("d", tt.DOUBLE))),
            jt.Schema((jt.StructField("k", jt.LONG),
                       jt.StructField("s", jt.STRING),
                       jt.StructField("d", jt.DOUBLE))))


@pytest.mark.parametrize("seed,n", [(0, 50), (1, 1), (2, 300)])
def test_dump_batch_reads_back_and_its_meta_matches_jax(tmp_path, seed, n):
    ts, js = schemas()
    d = data(seed, n)
    tb = ColumnarBatch.from_pydict(d, ts, device="cpu")
    jb = JBatch.from_pydict(d, js)
    tp = tdump.dump_batch(tb, str(tmp_path / "t" / "b.parquet"))
    jp = jdump.dump_batch(jb, str(tmp_path / "j" / "b.parquet"))
    back = ColumnarBatch.from_arrow(pq.read_table(tp), device="cpu")
    assert back.to_pylist() == tb.to_pylist() == jb.to_pylist()
    assert pq.read_table(tp).equals(pq.read_table(jp))
    tmeta = json.loads(Path(tp + ".meta.json").read_text())
    jmeta = json.loads(Path(jp + ".meta.json").read_text())
    assert tmeta == jmeta


def scoped_failure(tmp_path, batches, op="TestOp"):
    conf = tconfig.RapidsConf({DUMP: str(tmp_path)})
    with pytest.raises(RuntimeError, match="boom"):
        with tdump.dump_on_error(op, conf) as scope:
            for b in batches:
                scope.observe(b)
            raise RuntimeError("boom")
    dirs = sorted(glob.glob(str(tmp_path / f"{op}-*")))
    assert len(dirs) == 1 and scope.out_dir == dirs[0]
    return Path(dirs[0])


def test_dump_on_error_writes_error_records_and_repro(tmp_path):
    ts, _ = schemas()
    batches = [ColumnarBatch.from_pydict(data(i), ts, device="cpu")
               for i in range(2)]
    out = scoped_failure(tmp_path, batches)
    assert sorted(os.listdir(out)) == [
        "error.txt", "input-0000.parquet", "input-0000.parquet.meta.json",
        "input-0001.parquet", "input-0001.parquet.meta.json", "repro.py"]
    err = (out / "error.txt").read_text()
    assert "RuntimeError: boom" in err and "Traceback" in err
    repro = (out / "repro.py").read_text()
    compile(repro, "repro.py", "exec")
    assert "spark_rapids_tpu_torch" in repro and "jax" not in repro
    # the repro loads the dumped batches on the CPU
    scope = {"__file__": str(out / "repro.py"), "__name__": "__main__"}
    exec(compile(repro, "repro.py", "exec"), scope)
    assert [b.to_pylist() for b in scope["batches"]] == \
        [b.to_pylist() for b in batches]


def test_without_pyarrow_a_record_is_the_failed_file(tmp_path,
                                                      monkeypatch):
    """The card's machine has no pyarrow: each batch's record is the
    `.FAILED` file the JAX package writes, naming the import error."""
    real_import = builtins.__import__

    def no_pyarrow(name, *args, **kwargs):
        if name.startswith("pyarrow"):
            raise ModuleNotFoundError("No module named 'pyarrow'")
        return real_import(name, *args, **kwargs)

    ts, _ = schemas()
    b = ColumnarBatch.from_pydict(data(3), ts, device="cpu")
    monkeypatch.setattr(builtins, "__import__", no_pyarrow)
    out = scoped_failure(tmp_path, [b])
    monkeypatch.undo()
    assert sorted(os.listdir(out)) == ["error.txt", "input-0000.FAILED",
                                       "repro.py"]
    assert "pyarrow" in (out / "input-0000.FAILED").read_text()


def test_dump_on_error_off_and_on_success(tmp_path):
    ts, _ = schemas()
    b = ColumnarBatch.from_pydict(data(4), ts, device="cpu")
    scope = tdump.dump_on_error("Off", tconfig.RapidsConf())
    assert not scope.enabled
    assert scope.observe(b) is b and scope._batches == []
    with pytest.raises(RuntimeError):
        with scope:
            raise RuntimeError("boom")
    conf = tconfig.RapidsConf({DUMP: str(tmp_path)})
    with tdump.dump_on_error("Ok", conf) as on:
        assert list(on.observe_iter(iter([b]))) == [b]
    assert os.listdir(tmp_path) == []


class _Src(TpuExec):
    def __init__(self, batches):
        super().__init__()
        self._batches = batches

    @property
    def output_schema(self):
        return self._batches[0].schema

    def internal_execute(self):
        yield from self._batches


class _Boom(TpuExec):
    """Fails on its second input batch."""

    @property
    def output_schema(self):
        return self.children[0].output_schema

    def internal_execute(self):
        for i, b in enumerate(self.children[0].execute()):
            if i == 1:
                raise ValueError("kernel exploded here")
            yield b


def drive_boom(tmp_path, path_value):
    ts, _ = schemas()
    batches = [ColumnarBatch.from_pydict(data(i), ts, device="cpu")
               for i in range(3)]
    src = _Src(batches)
    tconfig.set_active_conf(tconfig.RapidsConf({DUMP: path_value}))
    try:
        with pytest.raises(ValueError, match="kernel exploded here"):
            list(_Boom(src).execute())
    finally:
        tconfig.set_active_conf(tconfig.RapidsConf())
    return src, batches


def test_operator_failure_dumps_its_inputs_and_reraises(tmp_path):
    src, batches = drive_boom(tmp_path, str(tmp_path))
    # the source yielded two batches; the failing operator's input is the
    # second, its last
    assert src._last_output is batches[1]
    (d,) = glob.glob(str(tmp_path / "_Boom-*"))
    assert "ValueError: kernel exploded here" in \
        Path(d, "error.txt").read_text()
    assert sorted(os.listdir(d)) == [
        "error.txt", "input-0000.parquet", "input-0000.parquet.meta.json",
        "repro.py"]
    back = ColumnarBatch.from_arrow(
        pq.read_table(os.path.join(d, "input-0000.parquet")), device="cpu")
    assert back.to_pylist() == batches[1].to_pylist()


def test_with_the_path_empty_no_batch_is_retained(tmp_path):
    src, _ = drive_boom(tmp_path, "")
    assert src._last_output is None
    assert os.listdir(tmp_path) == []


def test_a_dump_that_fails_never_masks_the_error(tmp_path):
    """dumpPath names a file, so the dump cannot make its directory: the
    operator's own error still comes out."""
    blocker = tmp_path / "file"
    blocker.write_text("")
    drive_boom(tmp_path, str(blocker))
    assert blocker.read_text() == ""


def test_the_jax_package_dumps_the_same_failure(tmp_path):
    """The JAX package's hook on the same failure writes the same files
    and the same input rows."""
    from spark_rapids_tpu.exec.base import TpuExec as JExec
    _, js = schemas()
    jbatches = [JBatch.from_pydict(data(i), js) for i in range(3)]

    class JSrc(JExec):
        output_schema = js

        def internal_execute(self):
            yield from jbatches

    class JBoom(JExec):
        output_schema = js

        def internal_execute(self):
            for i, b in enumerate(self.children[0].execute()):
                if i == 1:
                    raise ValueError("kernel exploded here")
                yield b

    jconfig.set_active_conf(jconfig.RapidsConf({DUMP: str(tmp_path / "j")}))
    try:
        with pytest.raises(ValueError):
            list(JBoom(JSrc()).execute())
    finally:
        jconfig.set_active_conf(jconfig.RapidsConf())
    drive_boom(tmp_path, str(tmp_path / "t"))
    (jd,) = glob.glob(str(tmp_path / "j" / "JBoom-*"))
    (td,) = glob.glob(str(tmp_path / "t" / "_Boom-*"))
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    assert pq.read_table(os.path.join(td, "input-0000.parquet")).equals(
        pq.read_table(os.path.join(jd, "input-0000.parquet")))
    assert json.loads(Path(td, "input-0000.parquet.meta.json").read_text()) \
        == json.loads(Path(jd, "input-0000.parquet.meta.json").read_text())


FAULT = {"spark.rapids.tpu.test.faults":
         "device.dispatch:prob=1.0,seed=1,kind=device,max=1",
         "spark.rapids.tpu.task.maxAttempts": "1"}


@pytest.fixture
def no_fault_plan():
    from spark_rapids_tpu_torch import faults
    faults.install(None)
    yield
    faults.install(None)


@pytest.mark.parametrize("fusion", ["true", "false"])
def test_planned_query_fault_dumps_and_raises_the_injected_error(
        tmp_path, fusion, no_fault_plan):
    """A planned filter and group-by with one injected device fault (the
    first `device.dispatch` check: the coalesce's upload) and task retry
    off: collect() raises the injected error itself, and every dump under
    the path holds it, its repro and one record per retained batch."""
    from spark_rapids_tpu_torch.faults import InjectedDeviceError
    ts, _ = schemas()
    conf = dict(FAULT, **{DUMP: str(tmp_path),
                          "spark.rapids.tpu.stage.fusion.enabled": fusion})
    sess = TpuSession(conf, device="cpu")
    df = sess.from_pydict(data(5, 200), ts, batch_rows=64) \
        .filter(F.col("d") > 0).group_by("k") \
        .agg((F.sum("d"), "s"), (F.count("s"), "c"))
    with pytest.raises(InjectedDeviceError, match="device.dispatch"):
        df.collect()
    dirs = {Path(d).name.split("-")[0]: Path(d)
            for d in glob.glob(str(tmp_path / "*"))}
    parent = "CompiledStageExec" if fusion == "true" else "AggregateExec"
    assert sorted(dirs) == sorted(["CoalesceBatchesExec", parent])
    for d in dirs.values():
        assert "InjectedDeviceError: injected device fault at " \
            "device.dispatch" in (d / "error.txt").read_text()
        repro = (d / "repro.py").read_text()
        assert "spark_rapids_tpu_torch" in repro and "jax" not in repro
    # the coalesce failed holding the last scan batch it pulled; its
    # parent pulled nothing from it
    assert sorted(os.listdir(dirs["CoalesceBatchesExec"])) == [
        "error.txt", "input-0000.parquet", "input-0000.parquet.meta.json",
        "repro.py"]
    assert sorted(os.listdir(dirs[parent])) == ["error.txt", "repro.py"]
    got = pq.read_table(dirs["CoalesceBatchesExec"] /
                        "input-0000.parquet").to_pydict()
    scan_batches = [{k: v[i:i + 64] for k, v in data(5, 200).items()}
                    for i in range(0, 200, 64)]
    assert got in scan_batches


def test_a_compiled_stage_failure_dumps_its_inputs(tmp_path, monkeypatch):
    """A CompiledStageExec whose step raises dumps the batch it pulled
    from its source, and the step's own error comes out."""
    from spark_rapids_tpu_torch.exec.stage_compiler import CompiledStageExec

    def broken(self, run, fault_key, *args, fixed=()):
        raise ValueError("stage step exploded")

    monkeypatch.setattr(CompiledStageExec, "_call", broken)
    ts, _ = schemas()
    sess = TpuSession({DUMP: str(tmp_path)}, device="cpu")
    df = sess.from_pydict(data(6, 100), ts) \
        .filter(F.col("d") > 0).group_by("k").agg((F.count("s"), "c"))
    with pytest.raises(ValueError, match="stage step exploded"):
        df.collect()
    (d,) = glob.glob(str(tmp_path / "CompiledStageExec-*"))
    assert "ValueError: stage step exploded" in \
        Path(d, "error.txt").read_text()
    back = pq.read_table(os.path.join(d, "input-0000.parquet"))
    assert back.to_pydict() == data(6, 100)
    # the root above the stage has no retained input: its dump is the
    # error and the repro
    tconfig.set_active_conf(tconfig.RapidsConf())


def test_rapids_conf_takes_any_dump_path(tmp_path):
    for v in ("", str(tmp_path), "/no/such/dir"):
        assert tconfig.RapidsConf({DUMP: v}).get(tconfig.DEBUG_DUMP_PATH) \
            == v
    assert tconfig.DEBUG_DUMP_PATH.key not in tconfig._UNREAD
    TpuSession({DUMP: str(tmp_path)}, device="cpu")
