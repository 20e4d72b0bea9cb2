"""Pandas UDF exec family — the counterpart of
spark_rapids_tpu/exec/python_udf.py: grouped map (applyInPandas), grouped
aggregate, mapInPandas/mapInBatch, cogrouped map and window-in-pandas.

Reference: the exec family under
sql-plugin/src/main/scala/org/apache/spark/sql/rapids/execution/python/
(GpuFlatMapGroupsInPandasExec.scala:79, GpuAggregateInPandasExec.scala,
GpuMapInBatchExec.scala, GpuFlatMapCoGroupsInPandasExec.scala,
GpuWindowInPandasExecBase.scala). There the plugin ships Arrow batches
over a socket to a Python worker; here the engine is the Python process,
so the transport is one device->host fetch a batch (ColumnarBatch.to_arrow)
and the group slicing a host pandas groupby over key columns the device
computed first.

- Each exec sees its whole input: the child's batches fold into one
  pandas frame before grouping (the reference requires an upstream hash
  partitioning for the same completeness).
- NULL keys form a group of their own, and NaN another (Spark's groupBy):
  pandas folds NULL into NaN at the arrow boundary, so each key rides
  with an IS NOT NULL lane that keeps the two apart.
- The function's frames come back through Arrow with the declared schema
  (a dtype mismatch fails at the boundary), as batches on the device the
  plan runs on, one packed upload each (io/multifile.arrow_to_batches).
- A pandas exec reads its child's compacted batches: it is not a fusable
  operator, so a compiled chain below it ends there (ROADMAP C.18).

pandas and pyarrow are imported when an exec runs: without either it
raises ImportError naming the package.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, List, Sequence, Tuple

from ..columnar.batch import ColumnarBatch
from ..expr.core import Expression, col
from ..types import DataType, Schema, StructField, to_arrow as _t2a
from .base import TpuExec
from .basic import bind_projection, eval_projection, projection_schema

_KEY_PREFIX = "__pandas_gkey_"
OP_TIME = "opTime"
_END = object()   # the end of a map function's stream of frames

_LOCK = threading.Lock()
_COUNTERS = {"fetch_ns": 0, "python_ns": 0, "upload_ns": 0,
             "rows_fetched": 0, "rows_uploaded": 0}


def counters() -> Dict[str, int]:
    """Where the pandas execs' time went: the fetch of their input to
    pandas frames (the child's batches waited for, one device->host copy
    a batch, arrow -> pandas), the Python side (the host grouping and the
    user's function), and the upload of the function's frames (pandas ->
    arrow, the host build, one packed upload a batch); with the rows each
    way."""
    with _LOCK:
        return dict(_COUNTERS)


def _add(key: str, value: int) -> None:
    with _LOCK:
        _COUNTERS[key] += value


@contextmanager
def _timed(key: str):
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        _add(key, time.perf_counter_ns() - t0)


def _pandas():
    import importlib
    try:
        return importlib.import_module("pandas")
    except ImportError as e:
        raise ImportError("the pandas UDFs need pandas, which is not "
                          "installed") from e


def _batch_to_pandas(batch: ColumnarBatch):
    from ..io.multifile import need_pyarrow
    _pandas()
    need_pyarrow("the pandas UDFs")
    with _timed("fetch_ns"):
        pdf = batch.to_arrow().to_pandas()
    _add("rows_fetched", len(pdf))
    return pdf


def _pandas_to_batches(pdf, schema: Schema, device,
                       max_rows: int = 1 << 20) -> List[ColumnarBatch]:
    """A pandas frame as batches of `schema` on `device`."""
    from ..io.multifile import arrow_to_batches, need_pyarrow
    pa = need_pyarrow("the pandas UDFs")
    if len(pdf) == 0:
        return []
    with _timed("upload_ns"):
        arrow_schema = pa.schema([pa.field(f.name, _t2a(f.data_type))
                                  for f in schema.fields])
        table = pa.Table.from_pandas(pdf[[f.name for f in schema.fields]],
                                     schema=arrow_schema,
                                     preserve_index=False)
        out = list(arrow_to_batches(table, max_rows, device, encoded=False))
    _add("rows_uploaded", len(pdf))
    return out


def _emit(outs, schema: Schema, device) -> List[ColumnarBatch]:
    """The function's non-empty frames, concatenated, as batches."""
    if not outs:
        return []
    with _timed("upload_ns"):
        merged = _pandas().concat(outs, ignore_index=True) \
            if len(outs) > 1 else outs[0]
    return _pandas_to_batches(merged, schema, device)


class _KeyedFrame:
    """The host side of a grouped pandas exec: the child's columns plus
    the key expressions and their IS NOT NULL lanes, evaluated on the
    device a batch at a time, fetched and concatenated into one pandas
    frame, then grouped."""

    def __init__(self, key_exprs: Sequence[Expression], in_schema: Schema):
        from ..expr.predicates import IsNotNull
        self.in_schema = in_schema
        self.key_names = [f"{_KEY_PREFIX}{i}"
                          for i in range(len(key_exprs))]
        self.valid_names = [f"{n}_valid" for n in self.key_names]
        pre = [col(n) for n in in_schema.names] + [
            k.alias(n) for k, n in zip(key_exprs, self.key_names)] + [
            IsNotNull(k).alias(n)
            for k, n in zip(key_exprs, self.valid_names)]
        self._bound = bind_projection(pre, in_schema)
        self.pre_schema = projection_schema(pre, in_schema)

    def keep_keys(self, n: int) -> None:
        """Group by the first `n` key expressions only (the rest are a
        UDF's inputs)."""
        self.key_names = self.key_names[:n]
        self.valid_names = self.valid_names[:n]

    def frame(self, batches):
        pd = _pandas()
        frames = [_batch_to_pandas(eval_projection(self._bound, b,
                                                   self.pre_schema))
                  for b in batches]
        frames = [f for f in frames if len(f)]
        if not frames:
            return None
        return pd.concat(frames, ignore_index=True) if len(frames) > 1 \
            else frames[0]

    def groups(self, pdf):
        """(key tuple, the group's frame without the key columns) each."""
        if not self.key_names:
            yield (), pdf
            return
        nk = len(self.key_names)
        by = self.key_names + self.valid_names
        for key, g in pdf.groupby(by, sort=True, dropna=False):
            if not isinstance(key, tuple):
                key = (key,)
            vals, valids = key[:nk], key[nk:]
            yield (tuple(None if not ok else k
                         for k, ok in zip(vals, valids)),
                   g.drop(columns=by))


class _PandasExecBase(TpuExec):
    def __init__(self, key_exprs: Sequence[Expression], child: TpuExec):
        super().__init__(child)
        self._keyed = _KeyedFrame(key_exprs, child.output_schema)

    def additional_metrics(self):
        return (OP_TIME,)

    def _host_frame(self):
        return self._keyed.frame(self.child.execute())


class GroupedMapInPandasExec(_PandasExecBase):
    """df.groupBy(keys).applyInPandas(fn, schema) — reference
    GpuFlatMapGroupsInPandasExec.scala:79."""

    def __init__(self, key_exprs: Sequence[Expression], fn: Callable,
                 out_schema: Schema, child: TpuExec):
        super().__init__(key_exprs, child)
        self.fn = fn
        self._out_schema = out_schema

    @property
    def output_schema(self) -> Schema:
        return self._out_schema

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        pd = _pandas()
        with self.metrics[OP_TIME].ns_timer():
            pdf = self._host_frame()
            if pdf is None:
                return
            outs = []
            with _timed("python_ns"):
                for _, g in self._keyed.groups(pdf):
                    r = self.fn(g.reset_index(drop=True))
                    if not isinstance(r, pd.DataFrame):
                        raise TypeError("applyInPandas function must "
                                        "return a pandas DataFrame")
                    if len(r):
                        outs.append(r)
            yield from _emit(outs, self._out_schema, self.device)


def _slots(names: List[str], specs) -> List[List[str]]:
    """Each UDF's input columns among `names`, in spec order."""
    out, pos = [], 0
    for _, _, _, ins in specs:
        out.append(names[pos: pos + len(ins)])
        pos += len(ins)
    return out


class AggregateInPandasExec(_PandasExecBase):
    """df.groupBy(keys).agg(pandas_udf) — one scalar per (group, agg);
    output = key columns + agg columns. Reference
    GpuAggregateInPandasExec.scala."""

    def __init__(self, key_exprs: Sequence[Expression],
                 aggs: Sequence[Tuple[Callable, str, DataType,
                                      Sequence[Expression]]],
                 key_names: Sequence[str], child: TpuExec):
        # aggs: (fn, output name, result type, input expressions); fn
        # receives one pandas Series per input expression. The inputs
        # ride the key projection after the keys, and are not grouped by.
        self._aggs = list(aggs)
        self._out_key_names = list(key_names)
        self._n_keys = len(key_exprs)
        inputs = [e for _, _, _, ins in self._aggs for e in ins]
        super().__init__(list(key_exprs) + inputs, child)
        self._agg_slots = _slots(self._keyed.key_names[self._n_keys:],
                                 self._aggs)
        self._keyed.keep_keys(self._n_keys)

    @property
    def output_schema(self) -> Schema:
        n_child = len(self.child.output_schema.fields)
        key_fields = self._keyed.pre_schema.fields[
            n_child: n_child + self._n_keys]
        return Schema(tuple(
            [StructField(n, k.data_type)
             for n, k in zip(self._out_key_names, key_fields)]
            + [StructField(name, rt) for _, name, rt, _ in self._aggs]))

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        pd = _pandas()
        with self.metrics[OP_TIME].ns_timer():
            pdf = self._host_frame()
            if pdf is None:
                return
            rows: List[tuple] = []
            with _timed("python_ns"):
                for key, g in self._keyed.groups(pdf):
                    rows.append(tuple(key) + tuple(
                        fn(*[g[s].reset_index(drop=True) for s in slots])
                        for (fn, _, _, _), slots in zip(self._aggs,
                                                        self._agg_slots)))
            schema = self.output_schema
            yield from _emit([pd.DataFrame(rows, columns=schema.names)],
                             schema, self.device)


class MapInBatchExec(TpuExec):
    """df.mapInPandas(fn, schema): fn(iterator of pandas DataFrames) ->
    iterator of DataFrames, streamed batch by batch. Reference
    GpuMapInBatchExec.scala (base of mapInPandas / mapInArrow)."""

    def __init__(self, fn: Callable, out_schema: Schema, child: TpuExec):
        super().__init__(child)
        self.fn = fn
        self._out_schema = out_schema

    @property
    def output_schema(self) -> Schema:
        return self._out_schema

    def additional_metrics(self):
        return (OP_TIME,)

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        with self.metrics[OP_TIME].ns_timer():
            fetched = [0]   # this exec's fetch ns, pulled by the function

            def frames():
                for b in self.child.execute():
                    t0 = time.perf_counter_ns()
                    pdf = _batch_to_pandas(b)
                    fetched[0] += time.perf_counter_ns() - t0
                    if len(pdf):
                        yield pdf
            outs = iter(self.fn(frames()))
            while True:
                # the function's time: its step less the fetches it pulled
                f0, t0 = fetched[0], time.perf_counter_ns()
                out = next(outs, _END)
                _add("python_ns", time.perf_counter_ns() - t0
                     - (fetched[0] - f0))
                if out is _END:
                    return
                yield from _pandas_to_batches(out, self._out_schema,
                                              self.device)


class _PandasSide(_KeyedFrame):
    """One cogroup input: its key projection and host grouping."""

    def host_groups(self, child: TpuExec):
        pdf = self.frame(child.execute())
        if pdf is None:
            return {}
        with _timed("python_ns"):
            return {k: g.reset_index(drop=True)
                    for k, g in self.groups(pdf)}

    def empty_frame(self):
        pd = _pandas()
        return pd.DataFrame({n: pd.Series([], dtype=object)
                             for n in self.in_schema.names})


class CoGroupedMapInPandasExec(TpuExec):
    """cogroup(left.groupBy(k), right.groupBy(k)).applyInPandas —
    fn(left_group_df, right_group_df) per key in either side (a missing
    side passes an empty frame). Reference
    GpuFlatMapCoGroupsInPandasExec.scala."""

    def __init__(self, left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], fn: Callable,
                 out_schema: Schema, left: TpuExec, right: TpuExec):
        super().__init__(left, right)
        self.fn = fn
        self._out_schema = out_schema
        self._lside = _PandasSide(left_keys, left.output_schema)
        self._rside = _PandasSide(right_keys, right.output_schema)

    @property
    def output_schema(self) -> Schema:
        return self._out_schema

    def additional_metrics(self):
        return (OP_TIME,)

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        pd = _pandas()
        with self.metrics[OP_TIME].ns_timer():
            lg = self._lside.host_groups(self.children[0])
            rg = self._rside.host_groups(self.children[1])
            keys = list(lg) + [k for k in rg if k not in lg]
            lempty = self._lside.empty_frame()
            rempty = self._rside.empty_frame()
            outs = []
            with _timed("python_ns"):
                for k in keys:
                    r = self.fn(lg.get(k, lempty), rg.get(k, rempty))
                    if not isinstance(r, pd.DataFrame):
                        raise TypeError("cogroup applyInPandas function "
                                        "must return a pandas DataFrame")
                    if len(r):
                        outs.append(r)
            yield from _emit(outs, self._out_schema, self.device)


class WindowInPandasExec(_PandasExecBase):
    """Whole-partition window over a pandas UDF: fn(input series...) ->
    scalar, broadcast to every row of the partition (the reference's
    GpuWindowInPandasExec main case, unbounded-to-unbounded frames,
    GpuWindowInPandasExecBase.scala)."""

    def __init__(self, part_exprs: Sequence[Expression],
                 wins: Sequence[Tuple[Callable, str, DataType,
                                      Sequence[Expression]]],
                 child: TpuExec):
        self._wins = list(wins)
        n_parts = len(part_exprs)
        inputs = [e for _, _, _, ins in self._wins for e in ins]
        super().__init__(list(part_exprs) + inputs, child)
        self._win_slots = _slots(self._keyed.key_names[n_parts:],
                                 self._wins)
        self._keyed.keep_keys(n_parts)

    @property
    def output_schema(self) -> Schema:
        return Schema(tuple(
            list(self.child.output_schema.fields)
            + [StructField(name, rt) for _, name, rt, _ in self._wins]))

    def internal_execute(self) -> Iterator[ColumnarBatch]:
        with self.metrics[OP_TIME].ns_timer():
            pdf = self._host_frame()
            if pdf is None:
                return
            child_names = list(self.child.output_schema.names)
            outs = []
            with _timed("python_ns"):
                for _, g in self._keyed.groups(pdf):
                    piece = g[child_names].reset_index(drop=True)
                    for (fn, name, _, _), slots in zip(self._wins,
                                                       self._win_slots):
                        piece[name] = fn(*[g[s].reset_index(drop=True)
                                           for s in slots])
                    outs.append(piece)
            yield from _emit(outs, self.output_schema, self.device)
