from .column import (  # noqa: F401
    Column, StringColumn, bucket_capacity, resolve_device,
)
from .encoded import DictionaryColumn  # noqa: F401
from .batch import ColumnarBatch, empty_batch  # noqa: F401
