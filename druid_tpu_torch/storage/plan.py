"""The persist-time planner: which encoding each column of a segment takes on
disk (segment format V2, storage/format_v2.py).

This is the reference package's staging planner as its V2 writer runs it
(`druid_tpu/data/cascade.py` `plan_pair`, with the LZ4 rung in its default
"device" mode), so both packages write the same parts for the same segment
and persist the same descriptors in `index.json`. It differs from the
port's own staging planner (`data/cascade.py`) in one rung only: a FLOAT or
DOUBLE column whose raw bytes LZ4 compresses at least LZ4_MIN_RATIO times
is claimed by LZ4 here (it persists as `col.<name>.lz4`), and stages
decoded in the port, which has no LZ4 rung (ROADMAP A6). Every other rung
is the port's own: `cascade._plan_time`, `cascade._plan_rle` and
`packed.plan_columns`, the same functions of the same cached stats.

The LZ4 stats are cached on the segment (`aux_cached`), so persisting a
segment twice (V2, then V1) compresses each float column once. The token
count, which only an eligible column's descriptor needs, is parsed from the
compressed block (`native/lz4block.tokenize`) only when the ratio passes.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from druid_tpu_torch.data import cascade, packed
from druid_tpu_torch.data.segment import ValueType
from druid_tpu_torch.engine.contracts import CASCADE_MAX_RUNS

#: LZ4 claims a float column only at this compression of its raw bytes
LZ4_MIN_RATIO = 2.0


def lz4_stat(segment, name: str) -> Tuple[int, int, int, int]:
    """Cached (raw bytes, compressed bytes, padded token count, padded
    literal bytes) of a float column. Compressed 0 marks a block that did
    not round-trip; the token counts are 0 where the ratio fails (the
    descriptor never reads them there)."""
    def _compute():
        from druid_tpu_torch.native import lz4block
        raw = np.ascontiguousarray(segment.metrics[name].values).tobytes()
        comp = lz4block.compress(raw)
        if lz4block.decompress(comp, len(raw)) != raw:
            return (len(raw), 0, 0, 0)
        if len(comp) * LZ4_MIN_RATIO > len(raw):
            return (len(raw), len(comp), 0, 0)
        lits, ll, _, _ = lz4block.tokenize(comp)
        return (len(raw), len(comp), cascade.pad_pow2(ll.shape[0]),
                cascade.pad_pow2(max(lits.shape[0], 1)))
    return segment.aux_cached(("storage_lz4stat", name), _compute)


def _plan_lz4(segment, name: str) -> Optional[Tuple]:
    raw, comp, tpad, lpad = lz4_stat(segment, name)
    if not comp or comp * LZ4_MIN_RATIO > raw:
        return None
    if tpad > CASCADE_MAX_RUNS:
        return None
    return ("lz4", lpad, tpad, int(segment.n_rows))


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


def descriptor_to_json(entries: Tuple) -> list:
    """JSON form of a cascade or pack descriptor tuple (format V2 persists
    the plan beside the parts)."""
    return [list(e) for e in entries]
