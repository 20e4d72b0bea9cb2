from .column import Column, bucket_capacity, resolve_device  # noqa: F401
from .batch import ColumnarBatch, empty_batch  # noqa: F401
