"""Build a port Segment from plain numpy arrays.

This is how data crosses from any other producer into the port: the caller
hands over the row timestamps, each dimension's ids and dictionary values,
each metric's value type and values, and the segment identity. Nothing but
numpy arrays, strings and ints crosses, so the port never sees a foreign
object.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from druid_tpu_torch.data.dictionary import Dictionary
from druid_tpu_torch.data.segment import (ComplexColumn, NumericColumn,
                                          Segment, SegmentId,
                                          StringDimColumn, ValueType)
from druid_tpu_torch.utils.intervals import Interval


def segment_from_arrays(time_ms: np.ndarray,
                        dims: Dict[str, Tuple[np.ndarray, Sequence[str]]],
                        metrics: Dict[str, Tuple[str, np.ndarray]],
                        datasource: str, interval: Tuple[int, int],
                        version: str = "v1", partition: int = 0) -> Segment:
    """`dims` maps a name to (int32 ids, sorted dictionary values);
    `metrics` maps a name to (value type "long"/"float"/"double", values)
    or to ("complex", 2-D values), such as HLL registers int8 [n, m];
    `interval` is (start, end) in epoch millis. Rows keep their order."""
    sid = SegmentId(datasource, Interval(int(interval[0]), int(interval[1])),
                    version, partition)
    dim_cols = {}
    for name, (ids, values) in dims.items():
        values = list(values)
        if values != sorted(values):
            raise ValueError(f"dictionary of {name!r} is not sorted")
        dim_cols[name] = StringDimColumn(
            np.ascontiguousarray(ids, dtype=np.int32), Dictionary(values))
    met_cols = {}
    for name, (vtype, values) in metrics.items():
        vt = ValueType(vtype)
        if vt is ValueType.COMPLEX:
            met_cols[name] = ComplexColumn(np.ascontiguousarray(values),
                                           "hyperUnique")
            continue
        met_cols[name] = NumericColumn(
            np.ascontiguousarray(values, dtype=vt.numpy_dtype), vt)
    return Segment(sid, np.asarray(time_ms, dtype=np.int64), dim_cols,
                   met_cols)
