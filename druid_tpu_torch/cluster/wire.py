"""Binary wire format for the broker ↔ data-node data plane (the port's own
copy of the reference package's `cluster/wire.py`, byte-compatible with it:
a reference broker reads a port node's payload and the other way round).

Reference analog: the serialized result stream a historical returns to
DirectDruidClient (client/DirectDruidClient.java:98 — JSON/smile rows over
Netty). The difference: what crosses the wire on the aggregate path is
*partial aggregation state* (AggregatePartials — dense per-key numpy arrays),
not finalized rows, so the broker's merge stays exact for HLL/sketch states.

Format ("tensor bundle", no pickle, nothing executable):

    MAGIC "DTPW" | u8 version | u32 header_len | header JSON | tensor bytes

The header describes the object tree; every numpy array is referenced by
index into a tensor table of (dtype, shape, offset) entries whose raw
little-endian bytes follow the header. Aggregator kernels travel as their
aggregator-spec JSON and are rebuilt against a null segment on the receiving
side — only their segment-independent merge behavior (combine / empty_state /
finalize) is exercised there.

Per-row device-staging arrays in GroupSpec (host_bucket_ids, host_keys) are
deliberately dropped from the wire: the broker merge needs only the compact
key space (host_unique), cardinalities, and bucket starts.

States are host numpy arrays (or dicts of them): every kernel's host_post
brings its device state back to the host before it leaves the engine, so
no torch tensor ever reaches the encoder. Kernels rebuild through the port's
make_kernel, so extension kernels come back once druid_tpu_torch.ext is
imported.
"""
from __future__ import annotations

import json
import struct
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"DTPW"
VERSION = 1
#: compressed tensor entries (enc: narrow/rle); emitted only when the
#: requester advertised support AND at least one tensor benefits, so a
#: version-1 peer never sees bytes it cannot parse
VERSION_COMPRESSED = 2

# HTTP content type for partials payloads (the data plane's "smile")
CONTENT_TYPE = "application/x-druid-tpu-partials"


class WireError(ValueError):
    pass


class WireStats:
    """Cumulative wire accounting: logical (raw little-endian) tensor bytes
    vs bytes actually emitted after per-tensor compression."""

    def __init__(self):
        self._lock = threading.Lock()
        self.logical_bytes = 0
        self.wire_bytes = 0
        self.compressed_payloads = 0

    def record(self, logical: int, wire: int, compressed: bool) -> None:
        with self._lock:
            self.logical_bytes += int(logical)
            self.wire_bytes += int(wire)
            if compressed:
                self.compressed_payloads += 1

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {"logicalBytes": self.logical_bytes,
                    "wireBytes": self.wire_bytes,
                    "compressedPayloads": self.compressed_payloads}


_WIRE_STATS = WireStats()


def wire_stats() -> WireStats:
    return _WIRE_STATS


class WireStatsMonitor:
    """Emits query/wire/{bytes,compressedBytes} per tick (deltas over the
    tick window). Duck-typed Monitor — utils.emitter only requires
    do_monitor."""

    def __init__(self, source: Optional[WireStats] = None):
        self.source = source or _WIRE_STATS
        self._last = self.source.snapshot()

    def do_monitor(self, emitter):
        s = self.source.snapshot()
        last, self._last = self._last, s
        emitter.metric("query/wire/bytes",
                       s["logicalBytes"] - last["logicalBytes"])
        emitter.metric("query/wire/compressedBytes",
                       s["wireBytes"] - last["wireBytes"])


# ---------------------------------------------------------------------------
# Tensor table
# ---------------------------------------------------------------------------

class _TensorTable:
    def __init__(self):
        self.arrays: List[np.ndarray] = []

    def add(self, a: np.ndarray) -> int:
        self.arrays.append(np.ascontiguousarray(a))
        return len(self.arrays) - 1

    def add_opt(self, a: Optional[np.ndarray]) -> Optional[int]:
        return None if a is None else self.add(np.asarray(a))

    def manifest_and_payload(self, compress: bool = False
                             ) -> Tuple[List[dict], bytes, int]:
        """(manifest, payload, logical_bytes). With compress=True each
        tensor additionally tries the bit-exact wire encodings (_wire_enc)
        and ships the smallest form; entries then carry an "enc" key and
        the payload needs a VERSION_COMPRESSED reader."""
        manifest, chunks, off, logical = [], [], 0, 0
        for a in self.arrays:
            if a.dtype == object:
                raise WireError("object arrays are not wire-serializable")
            data = a.tobytes()
            logical += len(data)
            entry = {"dtype": a.dtype.str, "shape": list(a.shape)}
            if compress:
                enc = _wire_enc(a, len(data))
                if enc is not None:
                    entry.update(enc[0])
                    data = enc[1]
            entry["off"], entry["len"] = off, len(data)
            off += len(data)
            chunks.append(data)
            manifest.append(entry)
        return manifest, b"".join(chunks), logical


def _int_view_dtype(dt: np.dtype) -> Optional[np.dtype]:
    """Same-width integer view dtype for run comparison: floats compare as
    bit patterns so -0.0 vs 0.0 and NaN payloads survive the round trip
    EXACTLY (value comparison would merge/kill them)."""
    if dt.kind in ("i", "u"):
        return dt
    if dt.kind == "f" and dt.itemsize in (4, 8):
        return np.dtype(f"<i{dt.itemsize}")
    if dt.kind == "b":
        return np.dtype(np.uint8)
    return None


def _wire_enc(a: np.ndarray, raw_len: int
              ) -> Optional[Tuple[dict, bytes]]:
    """Best bit-exact wire encoding of `a`, or None to ship raw.

    "rle":    1-D run tables (values + int32 lengths) over the integer bit
              view — the dominant win for broker partials, whose per-key
              state arrays are mostly constant runs on RLE-friendly data.
    "narrow": integers recast to the smallest signed dtype holding
              min/max (counts and dictionary ids rarely need 8 bytes).
    """
    if a.size < 16:
        return None
    best: Optional[Tuple[dict, bytes]] = None

    vdt = _int_view_dtype(a.dtype)
    if vdt is not None and a.ndim == 1:
        v = a.view(vdt)
        changes = np.flatnonzero(v[1:] != v[:-1])
        n_runs = int(changes.shape[0]) + 1
        rle_len = n_runs * (vdt.itemsize + 4)
        if rle_len < raw_len:
            starts = np.concatenate([[0], changes + 1])
            values = v[starts]
            lengths = np.diff(np.concatenate(
                [starts, [v.shape[0]]])).astype(np.int32)
            best = ({"enc": "rle", "runs": n_runs, "vdtype": vdt.str},
                    values.tobytes() + lengths.tobytes())

    if a.dtype.kind in ("i", "u"):
        lo = int(a.min())
        hi = int(a.max())
        for sdt in (np.int8, np.int16, np.int32):
            d = np.dtype(sdt)
            if d.itemsize >= a.dtype.itemsize:
                break
            if np.iinfo(d).min <= lo and hi <= np.iinfo(d).max:
                nlen = a.size * d.itemsize
                if nlen < raw_len and (best is None
                                       or nlen < len(best[1])):
                    best = ({"enc": "narrow", "sdtype": d.str},
                            a.astype(d).tobytes())
                break
    return best


def _read_tensors(manifest: Sequence[dict], payload: memoryview
                  ) -> List[np.ndarray]:
    out = []
    for m in manifest:
        dt = np.dtype(m["dtype"])
        if dt == object or dt.hasobject:
            raise WireError("object dtype in wire payload")
        buf = payload[m["off"]: m["off"] + m["len"]]
        enc = m.get("enc")
        if enc == "rle":
            vdt = np.dtype(m["vdtype"])
            if vdt.hasobject:
                raise WireError("object dtype in wire payload")
            n_runs = int(m["runs"])
            split = n_runs * vdt.itemsize
            values = np.frombuffer(buf[:split], dtype=vdt)
            lengths = np.frombuffer(buf[split:], dtype=np.int32)
            if lengths.shape[0] != n_runs or int(lengths.sum()) < 0:
                raise WireError("malformed rle tensor entry")
            a = np.repeat(values, lengths).view(dt).reshape(m["shape"])
            out.append(a.copy())
        elif enc == "narrow":
            sdt = np.dtype(m["sdtype"])
            if sdt.hasobject:
                raise WireError("object dtype in wire payload")
            a = np.frombuffer(buf, dtype=sdt).astype(dt)
            out.append(a.reshape(m["shape"]))
        elif enc is None:
            out.append(np.frombuffer(buf, dtype=dt)
                       .reshape(m["shape"]).copy())
        else:
            raise WireError(f"unknown tensor encoding {enc!r}")
    return out


# ---------------------------------------------------------------------------
# State pytrees (numpy arrays or string-keyed dicts of arrays)
# ---------------------------------------------------------------------------

def _enc_state(x, tt: _TensorTable):
    if isinstance(x, np.ndarray):
        return {"a": tt.add(x)}
    if isinstance(x, dict):
        return {"d": {k: _enc_state(v, tt) for k, v in x.items()}}
    if isinstance(x, np.generic):
        return {"a": tt.add(np.asarray(x))}
    raise WireError(f"state leaf not serializable: {type(x).__name__}")


def _dec_state(x, tensors: List[np.ndarray]):
    if "a" in x:
        return tensors[x["a"]]
    return {k: _dec_state(v, tensors) for k, v in x["d"].items()}


# ---------------------------------------------------------------------------
# GroupSpec / kernels
# ---------------------------------------------------------------------------

def _enc_spec(spec, tt: _TensorTable) -> dict:
    return {
        "bucket_starts": tt.add(np.asarray(spec.bucket_starts)),
        "bucket_mode": spec.bucket_mode,
        "uniform_period": int(spec.uniform_period),
        "uniform_first_offset": int(spec.uniform_first_offset),
        "key_mode": spec.key_mode,
        "dims": [{"column": d.column, "cardinality": int(d.cardinality),
                  "remap": tt.add_opt(d.remap)} for d in spec.dims],
        "host_unique": tt.add_opt(spec.host_unique),
        "num_total": int(spec.num_total),
    }


def _dec_spec(j: dict, tensors: List[np.ndarray]):
    from druid_tpu_torch.engine.grouping import GroupSpec, KeyDim
    t = lambda i: None if i is None else tensors[i]
    return GroupSpec(
        bucket_starts=t(j["bucket_starts"]),
        bucket_mode=j["bucket_mode"],
        uniform_period=j["uniform_period"],
        uniform_first_offset=j["uniform_first_offset"],
        host_bucket_ids=None,
        key_mode=j["key_mode"],
        dims=tuple(KeyDim(d["column"], d["cardinality"], t(d["remap"]))
                   for d in j["dims"]),
        host_keys=None,
        host_unique=t(j["host_unique"]),
        num_total=j["num_total"],
    )


class _NullSegment:
    """Segment stand-in for rebuilding kernels whose merge-side behavior
    (combine / empty_state / finalize_array) is segment-independent."""
    dims: Dict = {}
    metrics: Dict = {}

    def staged_dtype(self, name):
        return np.int64

    def aux_cached(self, key, fn):
        return fn()


_NULL_SEGMENT = _NullSegment()


def rebuild_kernels(agg_jsons: Sequence[dict]):
    """Kernels for the merge/finish side, from aggregator-spec JSON."""
    from druid_tpu_torch.query import aggregators as A
    from druid_tpu_torch.engine.filters import ConstNode
    from druid_tpu_torch.engine.kernels import FilteredKernel, make_kernel

    def one(spec):
        if isinstance(spec, A.FilteredAggregator):
            # the filter only gates update(); merge-side it is inert
            return FilteredKernel(spec, one(spec.delegate), ConstNode(True))
        return make_kernel(spec, _NULL_SEGMENT)

    return [one(A.agg_from_json(j)) for j in agg_jsons]


# ---------------------------------------------------------------------------
# AggregatePartials
# ---------------------------------------------------------------------------

def dumps_partials(ap, served: Sequence[str] = (),
                   trace: Sequence[dict] = (),
                   missing: Sequence[str] = (),
                   compress: bool = False) -> bytes:
    """Serialize AggregatePartials (+ the served-segment-id set the node is
    acknowledging, and the node's finished trace spans — plain JSON dicts —
    so the broker can assemble one end-to-end trace per query; both ride in
    the same payload). `missing` makes the partial-result contract explicit
    on the wire: segment ids the node was ASKED for but could not serve —
    the broker's degradation report composes from these, and a
    broker-of-brokers tier can propagate them without re-deriving the
    requested set.

    compress=True enables the bit-exact per-tensor wire encodings; emit
    it only for peers that advertised support ("wireCompress") — the
    payload then carries wire version 2 when any tensor benefits."""
    tt = _TensorTable()
    partials = []
    for p in ap.partials:
        partials.append({
            "spec": _enc_spec(p.spec, tt),
            "counts": tt.add(np.asarray(p.counts)),
            "states": {k: _enc_state(v, tt) for k, v in p.states.items()},
            "aggs": [k.spec.to_json() for k in p.kernels],
        })
    header = {
        "partials": partials,
        "dim_values": ap.dim_values,
        "spans": [[int(a), int(b)] for a, b in ap.spans],
        "intervals": None if ap.intervals is None
        else [[iv.start, iv.end] for iv in ap.intervals],
        "served": sorted(served),
        "missing": sorted(str(s) for s in missing),
        "trace": list(trace),
    }
    manifest, payload, logical = tt.manifest_and_payload(compress=compress)
    header["tensors"] = manifest
    hj = json.dumps(header).encode()
    any_enc = any("enc" in m for m in manifest)
    version = VERSION_COMPRESSED if any_enc else VERSION
    body = MAGIC + struct.pack("<BI", version, len(hj)) + hj + payload
    _WIRE_STATS.record(logical, len(payload), any_enc)
    return body


class PartialsPayload(tuple):
    """The decoded partials bundle: unpacks as the 3-tuple
    (AggregatePartials, served ids, trace spans) every existing caller
    expects, with the explicit partial-result report as `.missing`
    (segment ids the node was asked for but could not serve; empty on a
    complete response or a pre-missing-field peer)."""

    def __new__(cls, ap, served, spans, missing=()):
        self = super().__new__(cls, (ap, served, spans))
        self.missing = sorted({str(s) for s in missing})
        return self


def loads_partials(data: bytes):
    """Returns a PartialsPayload — unpackable as
    (AggregatePartials, served_segment_ids, trace_spans)."""
    from druid_tpu_torch.engine.engines import AggregatePartials
    from druid_tpu_torch.engine.grouping import SegmentPartial
    from druid_tpu_torch.utils.intervals import Interval

    mv = memoryview(data)
    if bytes(mv[:4]) != MAGIC:
        raise WireError("bad magic")
    if len(mv) < 9:
        raise WireError("truncated payload")
    version, hlen = struct.unpack("<BI", mv[4:9])
    if version not in (VERSION, VERSION_COMPRESSED):
        raise WireError(f"unsupported wire version {version}")
    try:
        header = json.loads(bytes(mv[9: 9 + hlen]))
    except ValueError as e:
        raise WireError(f"truncated or corrupt header: {e}") from None
    payload = mv[9 + hlen:]
    if any(m["off"] + m["len"] > len(payload) for m in header["tensors"]):
        raise WireError("truncated payload")
    tensors = _read_tensors(header["tensors"], payload)

    partials = []
    for pj in header["partials"]:
        kernels = rebuild_kernels(pj["aggs"])
        partials.append(SegmentPartial(
            segment=None,
            spec=_dec_spec(pj["spec"], tensors),
            counts=tensors[pj["counts"]],
            states={k: _dec_state(v, tensors)
                    for k, v in pj["states"].items()},
            kernels=kernels))
    intervals = header["intervals"]
    ap = AggregatePartials(
        partials=partials,
        dim_values=header["dim_values"],
        spans=[tuple(s) for s in header["spans"]],
        intervals=None if intervals is None
        else tuple(Interval(a, b) for a, b in intervals))
    return PartialsPayload(ap, set(header["served"]),
                           list(header.get("trace") or ()),
                           missing=header.get("missing") or ())
