"""Deep storage SPI: where immutable segment files live.

The port's copy of the reference package's `storage/deep.py`. Reference
analog: api/.../segment/loading/DataSegmentPusher + DataSegmentPuller and
their impls (LocalDataSegmentPuller/Pusher; s3/hdfs in extensions).
Segment files use the on-disk formats of storage/format.py and
storage/format_v2.py (smoosh container + LZ4 columns), so a pulled segment
mmaps straight back. `LocalDeepStorage(base_dir, format_version=2)` pushes
format V2; `format_version=1` pushes V1 (the reference picks with its
DRUID_TPU_SEGMENT_FORMAT environment variable; the port reads none).
"""
from __future__ import annotations

import os
import shutil
import threading
from typing import Dict, Optional

from druid_tpu_torch.cluster.metadata import SegmentDescriptor
from druid_tpu_torch.data.segment import Segment


class DeepStorage:
    def push(self, segment: Segment, descriptor: SegmentDescriptor
             ) -> SegmentDescriptor:
        """Store the segment; returns the descriptor with its loadSpec set."""
        raise NotImplementedError

    def pull(self, descriptor: SegmentDescriptor) -> Optional[Segment]:
        raise NotImplementedError

    def kill(self, descriptor: SegmentDescriptor) -> bool:
        """Delete the stored segment file (KillTask's storage step)."""
        raise NotImplementedError

    #: the live storage location segments restore back into
    BASE_LOCATION = "base"

    def move(self, descriptor: SegmentDescriptor,
             location: str) -> Optional[SegmentDescriptor]:
        """Relocate the stored files to a named location ("archive", a
        custom target, or BASE_LOCATION to restore) and return the
        descriptor with its loadSpec updated, or None if the segment is
        absent (reference: DataSegmentArchiver / MoveTask's storage step)."""
        raise NotImplementedError


class InMemoryDeepStorage(DeepStorage):
    """Test/local double — the role S3 plays in production."""

    def __init__(self):
        self._store: Dict[str, Segment] = {}
        self._lock = threading.Lock()

    def push(self, segment, descriptor):
        with self._lock:
            self._store[descriptor.id] = segment
        return SegmentDescriptor(
            descriptor.datasource, descriptor.interval, descriptor.version,
            descriptor.partition, descriptor.shard_spec,
            descriptor.size_bytes, descriptor.num_rows,
            {"type": "memory", "key": descriptor.id})

    def pull(self, descriptor):
        with self._lock:
            return self._store.get(descriptor.id)

    def kill(self, descriptor):
        with self._lock:
            return self._store.pop(descriptor.id, None) is not None

    def move(self, descriptor, location):
        # one shared dict: a move only re-tags the loadSpec location
        with self._lock:
            if descriptor.id not in self._store:
                return None
        spec = {"type": "memory", "key": descriptor.id}
        if location != self.BASE_LOCATION:
            spec["location"] = location
        return SegmentDescriptor(
            descriptor.datasource, descriptor.interval, descriptor.version,
            descriptor.partition, descriptor.shard_spec,
            descriptor.size_bytes, descriptor.num_rows, spec)


class LocalDeepStorage(DeepStorage):
    """Directory-per-segment local deep storage using the V9-analog on-disk
    format (smoosh + LZ4) — LocalDataSegmentPusher/Puller."""

    def __init__(self, base_dir: str, format_version: int = 2):
        self.base_dir = base_dir
        self.format_version = format_version
        os.makedirs(base_dir, exist_ok=True)

    def _dir(self, descriptor: SegmentDescriptor) -> str:
        safe = descriptor.id.replace("/", "_")
        return os.path.join(self.base_dir, descriptor.datasource, safe)

    def push(self, segment, descriptor):
        # format V2 unless this storage was built to push V1: the pushed
        # files keep their cascade form on disk
        from druid_tpu_torch.storage.format_v2 import persist_segment_auto
        d = self._dir(descriptor)
        os.makedirs(d, exist_ok=True)
        persist_segment_auto(segment, d, self.format_version)
        size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
        return SegmentDescriptor(
            descriptor.datasource, descriptor.interval, descriptor.version,
            descriptor.partition, descriptor.shard_spec, size,
            descriptor.num_rows, {"type": "local", "path": d})

    def pull(self, descriptor):
        from druid_tpu_torch.storage.format import load_segment
        d = (descriptor.load_spec or {}).get("path") or self._dir(descriptor)
        if not os.path.isdir(d):
            return None
        return load_segment(d)

    def kill(self, descriptor):
        d = (descriptor.load_spec or {}).get("path") or self._dir(descriptor)
        if os.path.isdir(d):
            shutil.rmtree(d)
            return True
        return False

    def move(self, descriptor, location):
        src = (descriptor.load_spec or {}).get("path") or \
            self._dir(descriptor)
        if location == self.BASE_LOCATION:
            dst = self._dir(descriptor)
        else:
            root = location if os.path.isabs(location) \
                else f"{self.base_dir.rstrip(os.sep)}_{location}"
            dst = os.path.join(root, descriptor.datasource,
                               os.path.basename(src.rstrip(os.sep)))
        if not os.path.isdir(src):
            # crash-idempotency: a prior run may have moved the files and
            # died before the metadata update — finding them already at
            # the destination completes that move instead of stranding it
            if not os.path.isdir(dst):
                return None
        elif os.path.abspath(src) != os.path.abspath(dst):
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            if os.path.isdir(dst):
                shutil.rmtree(dst)   # re-run of a partially-copied move
            shutil.move(src, dst)
        return SegmentDescriptor(
            descriptor.datasource, descriptor.interval, descriptor.version,
            descriptor.partition, descriptor.shard_spec,
            descriptor.size_bytes, descriptor.num_rows,
            {"type": "local", "path": dst})
