"""Segment storage: the V1 and V2 on-disk formats in a smoosh container,
the block codecs over the host LZ4 codec, and deep storage (the port's copy
of the reference package's `storage/`)."""
from druid_tpu_torch.storage.codec import (compress_array, decompress_array,
                                           default_codec, LZ4, NONE, ZLIB)
from druid_tpu_torch.storage.format import (load_segment, persist_segment,
                                            read_format_version,
                                            read_segment_meta)
from druid_tpu_torch.storage.format_v2 import (persist_segment_auto,
                                               persist_segment_v2)
from druid_tpu_torch.storage.smoosh import (CorruptSegmentError,
                                            FileSmoosher, SmooshedFileMapper)

__all__ = [
    "compress_array", "decompress_array", "default_codec", "LZ4", "NONE",
    "ZLIB", "load_segment", "persist_segment", "persist_segment_auto",
    "persist_segment_v2", "read_format_version", "read_segment_meta",
    "CorruptSegmentError", "FileSmoosher", "SmooshedFileMapper",
]
