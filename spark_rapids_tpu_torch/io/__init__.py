"""Sources and writers of the file formats (the counterpart of
spark_rapids_tpu/io/): Parquet, CSV, JSON, ORC and Iceberg through
pyarrow, Avro and Hive text in pure Python, and the multi-file machinery
they share. pyarrow is imported only when a reader or writer that needs
it is built."""

from .parquet import ParquetSource, write_parquet  # noqa: F401
from .csv import CsvSource  # noqa: F401
from .json import JsonSource  # noqa: F401
