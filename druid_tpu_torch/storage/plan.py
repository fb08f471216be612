"""The persist-time planner: which encoding each column of a segment takes on
disk (segment format V2, storage/format_v2.py).

This is the reference package's staging planner as its V2 writer runs it
(`druid_tpu/data/cascade.py` `plan_pair` with its defaults: the rungs on,
the LZ4 rung in "device" mode), so both packages write the same parts for
the same segment and persist the same descriptors in `index.json`. It is
the port's own staging planner (`data/cascade.py`: `_plan_time`,
`_plan_rle`, the LZ4 rung's cached stats and tokens, and
`packed.plan_columns`) with its switches at their defaults, whatever the
process has set them to: what a segment persists as does not depend on
`cascade.set_enabled` or `cascade.set_lz4_mode`. A float column whose raw
bytes LZ4 compresses at least `cascade.LZ4_MIN_RATIO` times persists as
`col.<name>.lz4`.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from druid_tpu_torch.data import cascade, packed
from druid_tpu_torch.data.segment import ValueType
from druid_tpu_torch.engine.contracts import CASCADE_MAX_RUNS


def _plan_lz4(segment, name: str) -> Optional[Tuple]:
    """The LZ4 rung in its "device" mode, whatever `cascade.lz4_mode` says:
    the cached stats and token arrays are the staging planner's."""
    raw, comp, tpad = cascade._lz4_stat(segment, name)
    if not comp or comp * cascade.LZ4_MIN_RATIO > raw \
            or tpad > CASCADE_MAX_RUNS:
        return None
    lits, ll, _, _, nv = cascade._lz4_encoded(segment, name)
    return ("lz4", int(lits.shape[0]), int(ll.shape[0]), int(nv))


def plan_column(segment, name: str) -> Optional[Tuple]:
    """The cascade descriptor tail of one column, or None. Reads column
    metadata and cached stats only, so a lazily loaded column plans without
    decoding."""
    if name == "__time_offset":
        return cascade._plan_time(segment)
    if name in segment.dims:
        return cascade._plan_rle(segment, name)
    m = segment.metrics.get(name)
    if m is None:
        return None
    if m.type is ValueType.LONG:
        if segment.staged_dtype(name) != np.int32:
            return None
        return cascade._plan_rle(segment, name)
    if m.type in (ValueType.FLOAT, ValueType.DOUBLE):
        return _plan_lz4(segment, name)
    return None


def plan_pair(segment, columns: Sequence[str]) -> Tuple[Tuple, Tuple]:
    """(cascade descriptor, pack descriptor) of `columns` in the segment's
    own row order: the cascade rungs claim first, packing covers the rest
    (`packed.plan_columns`, which `packed.set_enabled(False)` empties)."""
    out = []
    for c in sorted(set(columns) | {"__time_offset"}):
        p = plan_column(segment, c)
        if p is not None:
            out.append((c,) + p)
    cascades = tuple(out)
    claimed = {e[0] for e in cascades}
    packs = packed.plan_columns(
        segment, [c for c in columns if c not in claimed])
    return cascades, packs
