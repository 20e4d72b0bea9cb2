"""The failure dump — the counterpart of spark_rapids_tpu/utils/dump.py
(the reference's DumpUtils.scala: dump the batches feeding a failing
operator to parquet so the bug reproduces offline, and
GpuCoreDumpHandler.scala:38: keep the crash's diagnostics).

`dump_batch` writes one batch as parquet plus a `.meta.json` sidecar;
`dump_on_error` wraps an operator drive and, on an exception, writes
`error.txt` (the traceback), one record per observed input batch and a
`repro.py` into a timestamped directory under
spark.rapids.sql.debug.dumpPath. The parquet write goes through pyarrow,
as the JAX package's does; where pyarrow is missing (or the write fails)
a batch's record is `input-NNNN.FAILED` holding the error, the JAX
package's design. The dump never masks the operator's error.
"""

from __future__ import annotations

import json
import os
import time
import traceback
from typing import Iterator, List


def dump_batch(batch, path: str) -> str:
    """One batch -> parquet + .meta.json (reference
    DumpUtils.dumpToParquetFile). The meta records what the JAX package's
    does: the row count, the capacity, the schema's simple names and the
    batch's bytes at capacity."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".",
                exist_ok=True)
    import pyarrow.parquet as pq
    pq.write_table(batch.to_arrow(), path)
    meta = {
        "num_rows": batch.num_rows_host,
        "capacity": batch.capacity,
        "schema": [(f.name, f.data_type.simple_name())
                   for f in batch.schema.fields],
        "device_size_bytes": batch.nbytes,
    }
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f, indent=2)
    return path


class dump_on_error:
    """Context manager around an operator drive: on an exception, dump the
    batches registered through observe() with the traceback and a repro
    script. Gated by spark.rapids.sql.debug.dumpPath (empty: off), read
    from `conf` or the calling thread's active conf."""

    def __init__(self, op_name: str, conf=None):
        from ..config import DEBUG_DUMP_PATH, active_conf
        c = conf or active_conf()
        self.root = c.get(DEBUG_DUMP_PATH)
        self.op_name = op_name
        self._batches: List = []
        #: the directory the last failure was dumped into (None: none yet)
        self.out_dir = None

    @property
    def enabled(self) -> bool:
        return bool(self.root)

    def observe(self, batch):
        if self.enabled:
            self._batches.append(batch)
        return batch

    def observe_iter(self, it: Iterator) -> Iterator:
        for b in it:
            yield self.observe(b)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is None or not self.enabled:
            return False
        stamp = time.strftime("%Y%m%d-%H%M%S")
        out = os.path.join(self.root, f"{self.op_name}-{stamp}")
        os.makedirs(out, exist_ok=True)
        self.out_dir = out
        with open(os.path.join(out, "error.txt"), "w") as f:
            f.write("".join(traceback.format_exception(exc_type, exc, tb)))
        for i, b in enumerate(self._batches):
            try:
                dump_batch(b, os.path.join(out, f"input-{i:04d}.parquet"))
            except Exception as dump_exc:  # noqa: BLE001 best-effort dump
                with open(os.path.join(out, f"input-{i:04d}.FAILED"),
                          "w") as f:
                    f.write(repr(dump_exc))
        with open(os.path.join(out, "repro.py"), "w") as f:
            f.write(_REPRO_TEMPLATE.format(op=self.op_name))
        return False  # never swallow the error


_REPRO_TEMPLATE = '''\
"""Generated repro for a failed {op} drive (reference DumpUtils).

Loads the dumped input batches on the CPU; re-apply the failing operator
by hand.
"""
import glob

import pyarrow.parquet as pq

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch

batches = []
for p in sorted(glob.glob(__file__.replace("repro.py", "input-*.parquet"))):
    batches.append(ColumnarBatch.from_arrow(pq.read_table(p), device="cpu"))
print(f"loaded {{len(batches)}} input batches for {op}")
'''
