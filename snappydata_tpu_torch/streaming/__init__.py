"""Streaming ingest (port of snappydata_tpu/streaming): micro-batch
queries over memory / file / socket / Kafka sources into an exactly-once
sink."""

from snappydata_tpu_torch.streaming.sink import SnappySink, EventType  # noqa: F401
from snappydata_tpu_torch.streaming.query import (  # noqa: F401
    StreamingQuery, MemorySource, FileSource,
)
