"""Partitioning primitives of the exchanges — the counterpart of
spark_rapids_tpu/parallel/ (only `exchange.partition_ids` so far; the
mesh lane waits for ROADMAP A.6)."""
