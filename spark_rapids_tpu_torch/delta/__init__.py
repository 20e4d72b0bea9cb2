"""Delta Lake — the counterpart of spark_rapids_tpu/delta/: one modern
protocol version, the transaction log (JSON actions and Parquet
checkpoints, log.py), snapshot reconstruction, stats-collecting writes and
the copy-on-write DELETE/UPDATE/MERGE/OPTIMIZE commands (table.py), all
against the engine with no delta-spark dependency (the reference's
delta-24x and delta-lake/common: GpuOptimisticTransaction.scala,
GpuDeltaCatalog, GpuMergeIntoCommand.scala,
GpuStatisticsCollection.scala).

The commands' per-file rewrites are device plans; the data files and
checkpoints go through pyarrow, imported only when one is read or
written."""

from .log import DeltaLog, Snapshot
from .table import DeltaTable, read_delta, write_delta

__all__ = ["DeltaLog", "Snapshot", "DeltaTable", "read_delta",
           "write_delta"]
