"""Sources of the scan: the Parquet reader and its multi-file machinery."""
