"""Streaming and batch ingestion: parsers and firehoses, the incremental
index, segment merging, the appenderator and the exactly-once stream
tasks (the reference package's `ingest/`, host numpy as there). Snapshots
of the in-flight hydrants and the merged segments are ordinary Segments:
the port's engines query them on the card (cluster/realtime.py,
engine/standing.py)."""
from druid_tpu_torch.ingest.incremental import IncrementalIndex
from druid_tpu_torch.ingest.input import (CombiningFirehose, DimensionsSpec,
                                          Firehose, InlineFirehose,
                                          InputRowParser, LocalFirehose,
                                          RowBatch, TimestampSpec,
                                          TransformSpec, firehose_from_json)
from druid_tpu_torch.ingest.merger import merge_segments
from druid_tpu_torch.ingest.receiver import EventReceiverFirehose
from druid_tpu_torch.ingest.appenderator import (Appenderator,
                                                 SegmentAllocator, Sink,
                                                 StreamAppenderatorDriver)
from druid_tpu_torch.ingest.streaming import (SimulatedStream,
                                              StreamIngestTask, StreamSource,
                                              StreamSupervisor,
                                              StreamSupervisorSpec,
                                              StreamTuningConfig)

__all__ = [
    "IncrementalIndex", "merge_segments", "EventReceiverFirehose",
    "InputRowParser", "TimestampSpec",
    "DimensionsSpec", "TransformSpec", "RowBatch", "Firehose",
    "InlineFirehose", "LocalFirehose", "CombiningFirehose",
    "firehose_from_json", "Appenderator", "SegmentAllocator", "Sink",
    "StreamAppenderatorDriver", "SimulatedStream", "StreamIngestTask",
    "StreamSource", "StreamSupervisor", "StreamSupervisorSpec",
    "StreamTuningConfig",
]
