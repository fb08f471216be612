"""Smoosh container: pack many named parts into few mmap-able chunk files.

The port's copy of the reference package's `storage/smoosh.py`, the same
files and bytes. Capability parity with Druid's smoosh format
(java-util/.../io/smoosh/FileSmoosher.java, SmooshedFileMapper.java): all
columns of a segment live in ≤chunk_size files `chunk_NNNNN.bin` plus a
`meta.smoosh` index of (name, chunk, start, end). Reading maps chunks with
mmap and hands out zero-copy memoryviews, so decompression (native LZ4)
reads straight from the page cache.
"""
from __future__ import annotations

import mmap
import os
from typing import Dict, List, Optional, Tuple

DEFAULT_CHUNK_SIZE = 1 << 31  # 2GB, like the reference's mmap limit
META_FILE = "meta.smoosh"


class CorruptSegmentError(ValueError):
    """A segment directory failed structural validation: bad magic/version,
    truncated chunk file, malformed meta line, or a part whose offsets fall
    outside its chunk. Carries the directory and (when known) the part name
    so historical load can log exactly what is broken and move on instead
    of dying on a raw ValueError/struct.error traceback."""

    def __init__(self, path: str, detail: str, part: Optional[str] = None):
        self.path = path
        self.part = part
        where = f"{path}[{part}]" if part else path
        super().__init__(f"corrupt segment {where}: {detail}")


def _chunk_name(i: int) -> str:
    return f"chunk_{i:05d}.bin"


class FileSmoosher:
    """Writer: add named byte parts; parts never span chunks."""

    def __init__(self, directory: str, chunk_size: int = DEFAULT_CHUNK_SIZE):
        self.directory = directory
        self.chunk_size = chunk_size
        os.makedirs(directory, exist_ok=True)
        self._entries: List[Tuple[str, int, int, int]] = []
        self._chunk_idx = 0
        self._chunk_pos = 0
        self._fh = None

    def _ensure_chunk(self, size: int):
        if self._fh is None or (self._chunk_pos + size > self.chunk_size
                                and self._chunk_pos > 0):
            if self._fh is not None:
                self._fh.close()
                self._chunk_idx += 1
            self._fh = open(os.path.join(
                self.directory, _chunk_name(self._chunk_idx)), "wb")
            self._chunk_pos = 0

    def add(self, name: str, data: bytes):
        if any(e[0] == name for e in self._entries):
            raise ValueError(f"duplicate smoosh part {name!r}")
        self._ensure_chunk(len(data))
        start = self._chunk_pos
        self._fh.write(data)
        self._chunk_pos += len(data)
        self._entries.append((name, self._chunk_idx, start, self._chunk_pos))

    def add_from_file(self, name: str, path: str,
                      copy_chunk: int = 1 << 20):
        """Stream a part in from a writeout file without materializing it
        (reference: FileWriteOutMedium — intermediate persist data lives in
        temp files, not heap)."""
        if any(e[0] == name for e in self._entries):
            raise ValueError(f"duplicate smoosh part {name!r}")
        size = os.path.getsize(path)
        self._ensure_chunk(size)
        start = self._chunk_pos
        with open(path, "rb") as src:
            while True:
                buf = src.read(copy_chunk)
                if not buf:
                    break
                self._fh.write(buf)
                self._chunk_pos += len(buf)
        self._entries.append((name, self._chunk_idx, start, self._chunk_pos))

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        with open(os.path.join(self.directory, META_FILE), "w") as f:
            f.write(f"v1,{self.chunk_size},{self._chunk_idx + 1}\n")
            for name, chunk, start, end in self._entries:
                f.write(f"{name},{chunk},{start},{end}\n")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SmooshedFileMapper:
    """Reader: mmap chunk files, hand out zero-copy memoryviews per part."""

    def __init__(self, directory: str):
        self.directory = directory
        self._parts: Dict[str, Tuple[int, int, int]] = {}
        meta_path = os.path.join(directory, META_FILE)
        if not os.path.exists(meta_path):
            raise CorruptSegmentError(directory, f"missing {META_FILE}")
        with open(meta_path) as f:
            header = f.readline().strip().split(",")
            if len(header) != 3 or header[0] != "v1":
                raise CorruptSegmentError(
                    directory, f"bad smoosh header {','.join(header)!r}")
            try:
                n_chunks = int(header[2])
            except ValueError:
                raise CorruptSegmentError(
                    directory, f"bad smoosh chunk count {header[2]!r}") \
                    from None
            for line in f:
                if not line.strip():
                    continue
                try:
                    name, chunk, start, end = line.rsplit(",", 3)
                    chunk, start, end = int(chunk), int(start), int(end)
                except ValueError:
                    raise CorruptSegmentError(
                        directory,
                        f"malformed meta line {line.strip()!r}") from None
                if not (0 <= chunk < n_chunks and 0 <= start <= end):
                    raise CorruptSegmentError(
                        directory,
                        f"part offsets out of range ({chunk},{start},{end})",
                        part=name)
                self._parts[name] = (chunk, start, end)
        self._maps: List[Optional[mmap.mmap]] = [None] * n_chunks
        self._files: List[Optional[object]] = [None] * n_chunks

    def names(self) -> List[str]:
        return list(self._parts.keys())

    def has(self, name: str) -> bool:
        return name in self._parts

    def part(self, name: str) -> memoryview:
        if name not in self._parts:
            raise CorruptSegmentError(self.directory, "part missing from "
                                      f"{META_FILE}", part=name)
        chunk, start, end = self._parts[name]
        if self._maps[chunk] is None:
            path = os.path.join(self.directory, _chunk_name(chunk))
            try:
                fh = open(path, "rb")
            except OSError as e:
                raise CorruptSegmentError(
                    self.directory, f"missing chunk file: {e}",
                    part=name) from None
            try:
                m = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
            except (OSError, ValueError) as e:   # zero-length/unmappable
                fh.close()
                raise CorruptSegmentError(
                    self.directory, f"unmappable chunk file {path}: {e}",
                    part=name) from None
            self._files[chunk] = fh
            self._maps[chunk] = m
        if end > len(self._maps[chunk]):
            raise CorruptSegmentError(
                self.directory,
                f"truncated chunk {chunk}: part needs bytes "
                f"[{start},{end}) of {len(self._maps[chunk])}", part=name)
        return memoryview(self._maps[chunk])[start:end]

    def part_size(self, name: str) -> int:
        chunk, start, end = self._parts[name]
        return end - start

    def close(self):
        for i, m in enumerate(self._maps):
            if m is not None:
                m.close()
                self._maps[i] = None
            if self._files[i] is not None:
                self._files[i].close()
                self._files[i] = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
