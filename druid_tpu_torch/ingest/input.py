"""Input row model: parsers, timestamp/dimension specs, firehoses, transforms.

The port's own copy of the reference package's `ingest/input.py`, with
the reference's parser registry (extension parsers such as
`ext/protobuf_parser.py` register a type) and its ingest-time row matcher
(`engine/filters.make_row_matcher`) for TransformSpec filters.

Capability parity with Druid's input layer
(api/.../data/input/InputRow.java, impl/ parsers — JSON/CSV/TSV/regex;
Firehose/FirehoseFactory SPI; segment/transform/TransformSpec.java).
Parsers emit COLUMN BATCHES (dicts of lists), not per-row objects, and the
IncrementalIndex vectorizes from there.
"""
from __future__ import annotations

import csv
import glob as globlib
import gzip
import json
import re
from dataclasses import dataclass
from datetime import datetime, timezone
from typing import (Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence)

import numpy as np

from druid_tpu_torch.query.filters import DimFilter, filter_from_json
from druid_tpu_torch.utils.expression import parse_expression
from druid_tpu_torch.utils.intervals import parse_ts


@dataclass(frozen=True)
class TimestampSpec:
    """Reference analog: api/.../data/input/impl/TimestampSpec.java."""
    column: str = "timestamp"
    format: str = "auto"        # auto | iso | millis | posix | nano | <strptime>
    missing_value: Optional[int] = None

    def parse(self, value) -> int:
        if value is None:
            if self.missing_value is not None:
                return self.missing_value
            raise ValueError(f"null timestamp in column {self.column!r}")
        f = self.format
        if f == "millis":
            return int(value)
        if f == "posix":
            return int(float(value) * 1000)
        if f == "nano":
            return int(value) // 1_000_000
        if f in ("auto", "iso"):
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                return int(value)
            s = str(value)
            if f == "auto" and s.lstrip("-").isdigit():
                return int(s)
            return parse_ts(s)
        dt = datetime.strptime(str(value), f)
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=timezone.utc)
        return int(dt.timestamp() * 1000)

    @staticmethod
    def from_json(j: Optional[dict]) -> "TimestampSpec":
        j = j or {}
        return TimestampSpec(j.get("column", "timestamp"),
                             j.get("format", "auto"),
                             j.get("missingValue"))

    def to_json(self) -> dict:
        return {"column": self.column, "format": self.format,
                "missingValue": self.missing_value}


@dataclass(frozen=True)
class DimensionsSpec:
    """Reference analog: api/.../data/input/impl/DimensionsSpec.java.
    Empty `dimensions` means schemaless discovery (all non-excluded,
    non-timestamp, non-metric fields become string dims).
    spatial_dimensions: ((dimName, (coord fields...)), ...) — the parser
    joins the coordinate fields into one 'x,y' string dim that
    SpatialFilter understands (SpatialDimensionSchema)."""
    dimensions: tuple = ()
    exclusions: tuple = ()
    spatial_dimensions: tuple = ()

    @staticmethod
    def from_json(j: Optional[dict]) -> "DimensionsSpec":
        j = j or {}
        dims = []
        for d in j.get("dimensions", []):
            dims.append(d if isinstance(d, str) else d["name"])
        spatial = tuple(
            (s["dimName"], tuple(s["dims"]))
            for s in j.get("spatialDimensions", []))
        return DimensionsSpec(tuple(dims),
                              tuple(j.get("dimensionExclusions", [])),
                              spatial)

    def to_json(self) -> dict:
        return {"dimensions": list(self.dimensions),
                "dimensionExclusions": list(self.exclusions),
                "spatialDimensions": [{"dimName": n, "dims": list(d)}
                                      for n, d in self.spatial_dimensions]}


class RowBatch:
    """A parsed batch: timestamps + per-column python-object lists.

    Columns hold raw parsed values (str for dims, numbers for metrics);
    the IncrementalIndex vectorizes from here.
    """

    def __init__(self, timestamps: List[int], columns: Dict[str, list]):
        self.timestamps = timestamps
        self.columns = columns

    def __len__(self):
        return len(self.timestamps)


class InputRowParser:
    """Parse raw records (dicts or lines) into RowBatches.

    Reference analog: api/.../data/input/impl/InputRowParser + ParseSpec
    (JSONParseSpec, CSVParseSpec, DelimitedParseSpec, RegexParseSpec).
    """

    def __init__(self, timestamp_spec: TimestampSpec,
                 dimensions_spec: DimensionsSpec,
                 fmt: str = "json",
                 columns: Optional[Sequence[str]] = None,
                 delimiter: str = "\t",
                 list_delimiter: str = "\x01",
                 pattern: Optional[str] = None):
        self.timestamp_spec = timestamp_spec
        self.dimensions_spec = dimensions_spec
        self.fmt = fmt
        self.columns = list(columns) if columns else None
        self.delimiter = delimiter
        self.list_delimiter = list_delimiter
        self.pattern = re.compile(pattern) if pattern else None

    #: extension parser types: "type" → constructor(json) (the reference's
    #: InputRowParser @JsonSubTypes registry, extended by DruidModules)
    _PARSER_TYPES: Dict[str, "Callable[[dict], InputRowParser]"] = {}

    @classmethod
    def register_type(cls, name: str, ctor) -> None:
        cls._PARSER_TYPES[name] = ctor

    @staticmethod
    def from_json(j: dict) -> "InputRowParser":
        t = j.get("type")
        if t and t not in ("string", "map", "hadoopyString"):
            ctor = InputRowParser._PARSER_TYPES.get(t)
            if ctor is None:
                # a forked peon deserializing a task spec may not have
                # imported the extension modules yet — registering them
                # here beats silently JSON-parsing binary records
                import druid_tpu_torch.ext  # noqa: F401
                ctor = InputRowParser._PARSER_TYPES.get(t)
            if ctor is None:
                raise ValueError(f"unknown parser type {t!r}")
            return ctor(j)
        ps = j.get("parseSpec", j)
        fmt = ps.get("format", "json")
        return InputRowParser(
            TimestampSpec.from_json(ps.get("timestampSpec")),
            DimensionsSpec.from_json(ps.get("dimensionsSpec")),
            fmt=("csv" if fmt == "csv" else "tsv" if fmt in ("tsv", "delimited")
                 else "regex" if fmt == "regex" else "json"),
            columns=ps.get("columns"),
            delimiter=ps.get("delimiter", "\t"),
            pattern=ps.get("pattern"))

    def to_json(self) -> dict:
        ps = {"format": self.fmt,
              "timestampSpec": self.timestamp_spec.to_json(),
              "dimensionsSpec": self.dimensions_spec.to_json()}
        if self.columns is not None:
            ps["columns"] = list(self.columns)
        if self.fmt == "tsv":
            ps["delimiter"] = self.delimiter
        if self.pattern is not None:
            ps["pattern"] = self.pattern.pattern
        return {"parseSpec": ps}

    # -- record-level decode --------------------------------------------
    def _decode(self, record) -> Optional[dict]:
        if isinstance(record, dict):
            return record
        line = record.decode("utf-8") if isinstance(record, bytes) else record
        line = line.rstrip("\n\r")
        if not line:
            return None
        if self.fmt == "json":
            return json.loads(line)
        if self.fmt in ("csv", "tsv"):
            delim = "," if self.fmt == "csv" else self.delimiter
            vals = next(csv.reader([line], delimiter=delim))
            if self.columns is None:
                raise ValueError(f"{self.fmt} parser requires explicit columns")
            return dict(zip(self.columns, vals))
        if self.fmt == "regex":
            m = self.pattern.match(line)
            if m is None:
                raise ValueError(f"regex did not match line: {line[:80]!r}")
            groups = m.groups()
            cols = self.columns or [f"column_{i + 1}"
                                    for i in range(len(groups))]
            return dict(zip(cols, groups))
        raise ValueError(f"unknown format {self.fmt}")

    def parse_batch(self, records: Iterable) -> RowBatch:
        """Parse an iterable of raw records into one columnar batch;
        malformed records raise (callers may count+skip per task config)."""
        ts_col = self.timestamp_spec.column
        explicit_dims = self.dimensions_spec.dimensions
        spatial_specs = self.dimensions_spec.spatial_dimensions
        spatial_fields = {f for _, fields in spatial_specs for f in fields}
        # spatial sources are read from the RAW record (pre-exclusion) and
        # consumed by the join — excluding them must not empty the joined
        # dim, and they don't become discovered dims of their own
        # (SpatialDimensionRowTransformer consumes them from the row)
        exclusions = (set(self.dimensions_spec.exclusions) | {ts_col}
                      | spatial_fields) - set(explicit_dims)
        timestamps: List[int] = []
        columns: Dict[str, list] = {d: [] for d in explicit_dims}
        spatial_src: Dict[str, list] = {f: [] for f in spatial_fields}
        n = 0
        for record in records:
            d = self._decode(record)
            if d is None:
                continue
            timestamps.append(self.timestamp_spec.parse(d.get(ts_col)))
            for f in spatial_src:
                spatial_src[f].append(d.get(f))
            # keep ALL non-timestamp fields: the dimensions spec decides what
            # becomes a dim downstream, but metric inputs must survive parse
            keys = [k for k in d.keys() if k not in exclusions]
            for k in keys:
                col = columns.get(k)
                if col is None:
                    col = columns[k] = [None] * n
                col.append(d.get(k))
            for k, col in columns.items():
                if len(col) < len(timestamps):
                    col.append(None)
            n += 1
        # join spatial coordinate fields into 'x,y' dims
        # (SpatialDimensionRowTransformer)
        for dim_name, fields in spatial_specs:
            src = [spatial_src[f] for f in fields]
            columns[dim_name] = [
                ",".join("" if c[i] is None else str(c[i]) for c in src)
                for i in range(n)]
        return RowBatch(timestamps, columns)


# ---------------------------------------------------------------------------
# Transforms (reference: segment/transform/TransformSpec.java,
# ExpressionTransform.java) — expression-computed columns + a pre-rollup
# row filter, applied on the columnar batch.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ExpressionTransform:
    name: str
    expression: str

    @staticmethod
    def from_json(j: dict) -> "ExpressionTransform":
        return ExpressionTransform(j["name"], j["expression"])

    def to_json(self) -> dict:
        return {"type": "expression", "name": self.name,
                "expression": self.expression}


@dataclass(frozen=True)
class TransformSpec:
    transforms: tuple = ()
    filter: Optional[DimFilter] = None

    @staticmethod
    def from_json(j: Optional[dict]) -> "TransformSpec":
        if not j:
            return TransformSpec()
        return TransformSpec(
            tuple(ExpressionTransform.from_json(t)
                  for t in j.get("transforms", [])),
            filter_from_json(j.get("filter")))

    def to_json(self) -> dict:
        return {"transforms": [t.to_json() for t in self.transforms],
                "filter": self.filter.to_json() if self.filter else None}

    def apply(self, batch: RowBatch) -> RowBatch:
        if not self.transforms and self.filter is None:
            return batch
        cols = dict(batch.columns)
        n = len(batch)
        if self.transforms:
            # bind only the columns the transform expressions reference
            exprs = [(t, parse_expression(t.expression))
                     for t in self.transforms]
            referenced = set()
            for _, e in exprs:
                referenced |= e.required_columns()
            bindings: Dict[str, object] = {"__time": np.asarray(
                batch.timestamps, dtype=np.int64)}
            for k in referenced:
                if k == "__time" or k not in cols:
                    continue
                v = cols[k]
                num = [x if isinstance(x, (int, float))
                       and not isinstance(x, bool) else _maybe_num(x)
                       for x in v]
                if all(isinstance(x, (int, float)) for x in num):
                    bindings[k] = np.asarray([float(x) for x in num])
                else:
                    bindings[k] = np.asarray(v, dtype=object)
            for t, e in exprs:
                val = np.asarray(e.evaluate(bindings))
                if val.ndim == 0:
                    val = np.full(n, val[()])
                cols[t.name] = list(val)
                bindings[t.name] = val
        if self.filter is not None:
            keep = _filter_rows(self.filter, batch.timestamps, cols, n)
            ts = [t for t, k in zip(batch.timestamps, keep) if k]
            cols = {name: [v for v, k in zip(vals, keep) if k]
                    for name, vals in cols.items()}
            return RowBatch(ts, cols)
        return RowBatch(batch.timestamps, cols)


def _maybe_num(x):
    try:
        return float(x)
    except (TypeError, ValueError):
        return x


def _filter_rows(flt: DimFilter, timestamps, cols: Dict[str, list],
                 n: int) -> np.ndarray:
    """Row-level filter on raw values (ingest-time; pre-dictionary)."""
    from druid_tpu_torch.engine.filters import make_row_matcher
    matcher = make_row_matcher(flt)
    rows_match = np.ones(n, dtype=bool)
    for i in range(n):
        row = {k: v[i] for k, v in cols.items()}
        row["__time"] = timestamps[i]
        rows_match[i] = matcher(row)
    return rows_match


# ---------------------------------------------------------------------------
# Firehoses (reference: api/.../data/input/FirehoseFactory.java,
# server/.../realtime/firehose/LocalFirehoseFactory.java) — batch iterators
# of raw records.
# ---------------------------------------------------------------------------

class Firehose:
    """Iterator of raw-record batches."""

    def batches(self, batch_size: int = 65536) -> Iterator[List]:
        raise NotImplementedError

    def to_json(self) -> dict:
        """Wire form consumed by firehose_from_json — required so tasks can
        ship to forked peons (ForkingTaskRunner)."""
        raise NotImplementedError(f"{type(self).__name__} is not serializable")

    def splits(self, n: int) -> List["Firehose"]:
        """Partition into ≤ n independent firehoses for parallel ingest
        (reference: SplittableInputSource.createSplits). Default:
        unsplittable → one split."""
        return [self]


class InlineFirehose(Firehose):
    def __init__(self, records: Sequence):
        self.records = list(records)

    def batches(self, batch_size: int = 65536):
        for i in range(0, len(self.records), batch_size):
            yield self.records[i:i + batch_size]

    def to_json(self) -> dict:
        return {"type": "inline", "data": list(self.records)}

    def splits(self, n: int) -> List["Firehose"]:
        if not self.records:
            return [self]
        n = max(1, min(n, len(self.records)))
        per = -(-len(self.records) // n)
        return [InlineFirehose(self.records[i:i + per])
                for i in range(0, len(self.records), per)]


class LocalFirehose(Firehose):
    """Reads newline-delimited files matching a glob (gzip-aware)."""

    def __init__(self, base_dir: str, glob: str = "*"):
        self.base_dir = base_dir
        self.glob = glob
        self.paths = sorted(globlib.glob(f"{base_dir}/{glob}"))

    def batches(self, batch_size: int = 65536):
        buf: List[str] = []
        for path in self.paths:
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rt") as f:
                for line in f:
                    buf.append(line)
                    if len(buf) >= batch_size:
                        yield buf
                        buf = []
        if buf:
            yield buf


    def to_json(self) -> dict:
        # explicit paths so SPLIT instances round-trip exactly (a split
        # shipped to a peon must not re-glob the whole directory)
        return {"type": "local", "baseDir": self.base_dir,
                "filter": self.glob, "paths": list(self.paths)}

    @classmethod
    def _from_paths(cls, base_dir: str, glob: str,
                    paths: Sequence[str]) -> "LocalFirehose":
        fh = cls.__new__(cls)
        fh.base_dir = base_dir
        fh.glob = glob
        fh.paths = list(paths)
        return fh

    def splits(self, n: int) -> List["Firehose"]:
        if len(self.paths) <= 1:
            return [self]
        n = max(1, min(n, len(self.paths)))
        return [LocalFirehose._from_paths(self.base_dir, self.glob,
                                          self.paths[i::n])
                for i in range(n)]


class CombiningFirehose(Firehose):
    def __init__(self, delegates: Sequence[Firehose]):
        self.delegates = list(delegates)

    def batches(self, batch_size: int = 65536):
        for d in self.delegates:
            yield from d.batches(batch_size)

    def to_json(self) -> dict:
        return {"type": "combining",
                "delegates": [d.to_json() for d in self.delegates]}


def firehose_from_json(j: dict) -> Firehose:
    t = j.get("type")
    if t == "local":
        if "paths" in j:
            # explicit split: do NOT re-glob the directory
            return LocalFirehose._from_paths(j["baseDir"],
                                             j.get("filter", "*"),
                                             j["paths"])
        return LocalFirehose(j["baseDir"], j.get("filter", "*"))
    if t == "inline":
        return InlineFirehose(j.get("data", "").splitlines()
                              if isinstance(j.get("data"), str)
                              else j["data"])
    if t == "combining":
        return CombiningFirehose([firehose_from_json(d)
                                  for d in j["delegates"]])
    if t == "receiver":
        from druid_tpu_torch.ingest.receiver import EventReceiverFirehose
        return EventReceiverFirehose(j["serviceName"],
                                     port=int(j.get("port", 0)))
    raise ValueError(f"unknown firehose type {t!r}")
