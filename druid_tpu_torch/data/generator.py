"""Synthetic segment generator for tests and benchmarks.

Capability parity with the reference's BenchmarkDataGenerator
(benchmarks/src/main/java/org/apache/druid/benchmark/datagen/BenchmarkDataGenerator.java
+ SegmentGenerator.java): distribution-controlled column value generation used
by the JMH suites (GroupByBenchmark.java:118-136 schema "basic.A").
Vectorized with numpy instead of per-row Java generators.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from druid_tpu_torch.data.dictionary import Dictionary
from druid_tpu_torch.data.segment import (NumericColumn, Segment,
                                    SegmentId, StringDimColumn, ValueType)
from druid_tpu_torch.utils.intervals import Interval


@dataclass(frozen=True)
class ColumnSpec:
    """One generated column.

    kind: "string" (dictionary dim), "long", "float", "double"
    distribution: "uniform" | "zipf" | "sequential" | "normal" | "enumerated"
    """
    name: str
    kind: str = "string"
    cardinality: int = 100          # for string dims
    distribution: str = "uniform"
    zipf_exponent: float = 1.5
    low: float = 0.0
    high: float = 100.0
    mean: float = 0.0
    std: float = 1.0
    values: Tuple[str, ...] = ()    # for enumerated
    probabilities: Tuple[float, ...] = ()


# "basic.A"-style default schema (reference GroupByBenchmark schemas)
BASIC_SCHEMA = (
    ColumnSpec("dimSequential", "string", cardinality=1000, distribution="sequential"),
    ColumnSpec("dimZipf", "string", cardinality=101, distribution="zipf"),
    ColumnSpec("dimUniform", "string", cardinality=100000, distribution="uniform"),
    ColumnSpec("metLongUniform", "long", low=0, high=500),
    ColumnSpec("metFloatNormal", "float", distribution="normal", mean=5000.0, std=1.0),
    ColumnSpec("sumLongSequential", "long", distribution="sequential", low=0, high=10000),
    ColumnSpec("sumFloatNormal", "float", distribution="normal", mean=0.0, std=100.0),
)


def _string_dictionary(card: int, width: int = 8) -> Dictionary:
    # zero-padded decimal strings sort lexicographically == numerically
    return Dictionary([f"v{idx:0{width}d}" for idx in range(card)])


class DataGenerator:
    def __init__(self, columns: Sequence[ColumnSpec] = BASIC_SCHEMA, seed: int = 9999):
        self.columns = list(columns)
        self.rng = np.random.default_rng(seed)
        self._dicts: Dict[str, Dictionary] = {
            c.name: (Dictionary(sorted(set(c.values))) if c.distribution == "enumerated"
                     else _string_dictionary(c.cardinality))
            for c in self.columns if c.kind == "string"
        }

    @property
    def dictionaries(self) -> Dict[str, Dictionary]:
        return dict(self._dicts)

    def _gen_ids(self, spec: ColumnSpec, n: int, card: int) -> np.ndarray:
        rng = self.rng
        if spec.distribution == "sequential":
            return (np.arange(n, dtype=np.int64) % card).astype(np.int32)
        if spec.distribution == "zipf":
            # bounded zipf over [0, card)
            ranks = np.arange(1, card + 1, dtype=np.float64)
            probs = ranks ** (-spec.zipf_exponent)
            probs /= probs.sum()
            return rng.choice(card, size=n, p=probs).astype(np.int32)
        if spec.distribution == "enumerated":
            probs = np.asarray(spec.probabilities, dtype=np.float64)
            probs /= probs.sum()
            return rng.choice(card, size=n, p=probs).astype(np.int32)
        return rng.integers(0, card, size=n).astype(np.int32)

    def _gen_numeric(self, spec: ColumnSpec, n: int) -> np.ndarray:
        rng = self.rng
        if spec.distribution == "sequential":
            span = max(int(spec.high - spec.low), 1)
            vals = spec.low + (np.arange(n, dtype=np.int64) % span)
        elif spec.distribution == "normal":
            vals = rng.normal(spec.mean, spec.std, size=n)
        elif spec.distribution == "zipf":
            vals = rng.zipf(spec.zipf_exponent, size=n).astype(np.float64)
        else:
            vals = rng.uniform(spec.low, spec.high, size=n)
        if spec.kind == "long":
            return np.asarray(vals, dtype=np.int64)
        if spec.kind == "float":
            return np.asarray(vals, dtype=np.float32)
        return np.asarray(vals, dtype=np.float64)

    def segment(self, n_rows: int, interval: Interval,
                datasource: str = "bench", version: str = "v1",
                partition: int = 0, sort_by_dims: bool = False) -> Segment:
        """Generate one segment with rows spread uniformly over `interval`.

        sort_by_dims=True writes rows in the reference's rollup sort order
        (IndexMergerV9 orders rows by dimension values within a time bucket,
        segment/IndexMergerV9.java:729; with a coarse queryGranularity that
        is dimension-first order) — the layout our ingestion path produces
        and the one the windowed grouped-reduction strategy exploits."""
        span = max(interval.width, 1)
        time_ms = interval.start + (
            np.sort(self.rng.integers(0, span, size=n_rows)).astype(np.int64))
        dims: Dict[str, StringDimColumn] = {}
        metrics: Dict[str, NumericColumn] = {}
        for spec in self.columns:
            if spec.kind == "string":
                d = self._dicts[spec.name]
                ids = self._gen_ids(spec, n_rows, d.cardinality)
                dims[spec.name] = StringDimColumn(ids, d)
            else:
                vtype = ValueType(spec.kind)
                metrics[spec.name] = NumericColumn(self._gen_numeric(spec, n_rows), vtype)
        if sort_by_dims and dims:
            order = np.lexsort(tuple(
                d.ids for d in reversed(list(dims.values()))))
            time_ms = time_ms[order]
            for d in dims.values():
                d.ids = d.ids[order]
            for m in metrics.values():
                m.values = m.values[order]
        sid = SegmentId(datasource, interval, version, partition)
        return Segment(sid, time_ms, dims, metrics)

    def segments(self, n_segments: int, rows_per_segment: int,
                 start: Interval, datasource: str = "bench",
                 sort_by_dims: bool = False) -> List[Segment]:
        """Generate n segments over consecutive sub-intervals sharing dictionaries
        (shared dictionaries enable the on-device collective merge path)."""
        width = start.width // n_segments
        out = []
        for i in range(n_segments):
            iv = Interval(start.start + i * width, start.start + (i + 1) * width)
            out.append(self.segment(rows_per_segment, iv, datasource=datasource,
                                    partition=0, version="v1",
                                    sort_by_dims=sort_by_dims))
        return out
