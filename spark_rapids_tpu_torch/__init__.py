"""spark_rapids_tpu_torch — the PyTorch/CUDA port of spark_rapids_tpu.

The JAX package stays beside it as the reference; this package imports
torch, never jax, and nothing of spark_rapids_tpu. Its modules keep the
JAX package's layout and names, so each has a counterpart of the same
path. The TPU's Pallas kernels become hand-written CUDA C++ kernels for
Hopper (csrc/, built at first use by kernels/build.py).

Entry points run on CUDA unless the caller passes device="cpu"; without
a card they raise instead of falling back. Users reach the engine through
`TpuSession` (api/session.py), its DataFrames and `functions`, configured
by a `RapidsConf` (config.py).
"""

from .columnar.batch import ColumnarBatch  # noqa: F401
from .columnar.column import Column, bucket_capacity  # noqa: F401
from .config import RapidsConf  # noqa: F401
from .api import functions  # noqa: F401
from .api.session import TpuSession  # noqa: F401
from .version import __version__  # noqa: F401
