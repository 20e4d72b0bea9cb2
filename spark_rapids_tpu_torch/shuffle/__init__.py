"""Host shuffle data plane — the counterpart of spark_rapids_tpu/shuffle/:
the reference's MULTITHREADED shuffle mode (RapidsShuffleInternalManager
Base.scala:238 writer, :569 reader). Partition blocks are serialized and
LZ4-compressed on a writer thread pool into per-map data and index files,
then fetched and decoded on a reader pool. The shard-to-shard exchange is
the mesh lane (parallel/exchange.py, exec/exchange.py's device lane); its
counters are manager.ici_counters()."""

from .manager import (HostShuffleManager, HostShuffleReader,
                      HostShuffleWriter, shuffle_manager)
from .serializer import (CODEC_COPY, CODEC_LZ4, CorruptFrameError,
                         deserialize_batch, serialize_batch)

__all__ = [
    "HostShuffleManager", "HostShuffleReader", "HostShuffleWriter",
    "shuffle_manager", "serialize_batch", "deserialize_batch",
    "CorruptFrameError", "CODEC_COPY", "CODEC_LZ4",
]
