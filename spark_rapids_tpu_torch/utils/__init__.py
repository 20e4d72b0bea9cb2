"""Utilities — the counterpart of spark_rapids_tpu/utils/ (tracing; the
failure dump, utils/dump.py, waits for ROADMAP A.9c)."""
