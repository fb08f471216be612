"""Filter planning: DimFilter trees -> row-mask programs over staged tensors.

The port's counterpart of the row-domain half of the reference package's
`engine/filters.py` (its `plan_filter` with device bitmaps off). String
predicates are evaluated on the host against the dimension dictionary into
a boolean lookup table; on the device the predicate is one gather,
`lut[ids]`. Numeric predicates compare the staged value column in its staged
dtype. Constants are folded out of the tree before any device work.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

import numpy as np
import torch

from druid_tpu_torch.data.dictionary import Dictionary
from druid_tpu_torch.data.segment import Segment, ValueType
from druid_tpu_torch.query import filters as F

Cols = Dict[str, torch.Tensor]


class FilterNode:
    """A planned filter over one segment's staged columns."""

    def required_device_columns(self) -> Set[str]:
        return set()

    def build(self, cols: Cols) -> torch.Tensor:
        """The bool row mask; `cols` maps column name -> staged tensor."""
        raise NotImplementedError


class ConstNode(FilterNode):
    def __init__(self, value: bool):
        self.value = value

    def build(self, cols):
        v = cols["__valid"]
        return torch.full(v.shape, self.value, dtype=torch.bool,
                          device=v.device)


class LutNode(FilterNode):
    """mask = lut[ids] — every dictionary predicate reduces to this."""

    def __init__(self, dim: str, lut: np.ndarray):
        self.dim = dim
        self.lut = torch.from_numpy(lut.astype(bool))

    def required_device_columns(self):
        return {self.dim}

    def build(self, cols):
        ids = cols[self.dim]
        return self.lut.to(ids.device)[ids.long()]


class NumericCmpNode(FilterNode):
    """lower <= col <= upper with optional strictness."""

    def __init__(self, column: str, lower, upper, lower_strict: bool,
                 upper_strict: bool):
        self.column = column
        self.lower, self.upper = lower, upper
        self.lower_strict, self.upper_strict = lower_strict, upper_strict

    def required_device_columns(self):
        return {self.column}

    def build(self, cols):
        v = cols[self.column]
        mask = torch.ones(v.shape, dtype=torch.bool, device=v.device)
        if self.lower is not None:
            lo = torch.tensor(self.lower, dtype=v.dtype, device=v.device)
            mask &= (v > lo) if self.lower_strict else (v >= lo)
        if self.upper is not None:
            hi = torch.tensor(self.upper, dtype=v.dtype, device=v.device)
            mask &= (v < hi) if self.upper_strict else (v <= hi)
        return mask


class NumericEqNode(FilterNode):
    def __init__(self, column: str, value):
        self.column = column
        self.value = value

    def required_device_columns(self):
        return {self.column}

    def build(self, cols):
        v = cols[self.column]
        return v == torch.tensor(self.value, dtype=v.dtype, device=v.device)


class NumericInNode(FilterNode):
    def __init__(self, column: str, values: List):
        self.column = column
        self.values = values

    def required_device_columns(self):
        return {self.column}

    def build(self, cols):
        v = cols[self.column]
        return torch.isin(v, torch.tensor(self.values, dtype=v.dtype,
                                          device=v.device))


class TimeIntervalsNode(FilterNode):
    """__time within k intervals; offsets [k, 2] relative to the interval
    start the block staged `__time_offset` from."""

    def __init__(self, offsets: np.ndarray):
        self.offsets = offsets.astype(np.int32)

    def build(self, cols):
        return time_mask(cols["__time_offset"], self.offsets)


class AndNode(FilterNode):
    def __init__(self, children: List[FilterNode]):
        self.children = children

    def required_device_columns(self):
        return set().union(*(c.required_device_columns()
                             for c in self.children))

    def build(self, cols):
        mask = self.children[0].build(cols)
        for c in self.children[1:]:
            mask = mask & c.build(cols)
        return mask


class OrNode(AndNode):
    def build(self, cols):
        mask = self.children[0].build(cols)
        for c in self.children[1:]:
            mask = mask | c.build(cols)
        return mask


class NotNode(FilterNode):
    def __init__(self, child: FilterNode):
        self.child = child

    def required_device_columns(self):
        return self.child.required_device_columns()

    def build(self, cols):
        return ~self.child.build(cols)


def time_mask(t: torch.Tensor, offsets: np.ndarray) -> torch.Tensor:
    """Rows whose int32 time offset lies in any [lo, hi) of `offsets`."""
    mask = torch.zeros(t.shape, dtype=torch.bool, device=t.device)
    for lo, hi in np.asarray(offsets, dtype=np.int64).tolist():
        mask |= (t >= lo) & (t < hi)
    return mask


def interval_offsets(intervals, t0: int) -> np.ndarray:
    """[k, 2] int32 interval bounds relative to `t0`, clipped to int32."""
    lo, hi = -(2**31) + 1, 2**31 - 1
    return np.asarray([[min(max(iv.start - t0, lo), hi),
                        min(max(iv.end - t0, lo), hi)] for iv in intervals],
                      dtype=np.int64).reshape(-1, 2).astype(np.int32)


# ---------------------------------------------------------------------------
# String predicate -> dictionary LUT
# ---------------------------------------------------------------------------

def _dictionary_lut(d: Dictionary, pred) -> np.ndarray:
    return np.fromiter((bool(pred(v)) for v in d.values), dtype=bool,
                       count=d.cardinality)


def _string_predicate(flt: F.DimFilter):
    if isinstance(flt, F.SelectorFilter):
        target = "" if flt.value is None else flt.value
        return lambda v: v == target
    if isinstance(flt, F.InFilter):
        vals = {("" if v is None else v) for v in flt.values}
        return lambda v: v in vals
    if isinstance(flt, F.BoundFilter):
        lo, up = flt.lower, flt.upper
        ls, us = flt.lower_strict, flt.upper_strict
        if flt.ordering == "numeric":
            def num_pred(v):
                try:
                    x = float(v)
                except (TypeError, ValueError):
                    return False
                if lo is not None:
                    lf = float(lo)
                    if x < lf or (ls and x == lf):
                        return False
                if up is not None:
                    uf = float(up)
                    if x > uf or (us and x == uf):
                        return False
                return True
            return num_pred

        def lex_pred(v):
            if lo is not None and (v < lo or (ls and v == lo)):
                return False
            if up is not None and (v > up or (us and v == up)):
                return False
            return True
        return lex_pred
    raise NotImplementedError(f"string filter {type(flt).__name__}")


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------

def plan_filter(flt: Optional[F.DimFilter],
                segment: Segment) -> Optional[FilterNode]:
    """Plan `flt` for `segment` and fold its constants: None (no filter),
    a ConstNode(False) root (nothing matches), or a constant-free tree."""
    if flt is None:
        return None
    node = _simplify(_plan(flt.optimize(), segment))
    if isinstance(node, ConstNode) and node.value:
        return None
    return node


_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1


def _plan(flt: F.DimFilter, segment: Segment) -> FilterNode:
    if isinstance(flt, F.TrueFilter):
        return ConstNode(True)
    if isinstance(flt, F.FalseFilter):
        return ConstNode(False)
    if isinstance(flt, F.AndFilter):
        return AndNode([_plan(f, segment) for f in flt.fields])
    if isinstance(flt, F.OrFilter):
        return OrNode([_plan(f, segment) for f in flt.fields])
    if isinstance(flt, F.NotFilter):
        return NotNode(_plan(flt.field, segment))
    if isinstance(flt, F.IntervalFilter):
        if flt.dimension != "__time":
            raise ValueError("interval filter supported on __time only")
        return TimeIntervalsNode(
            interval_offsets(flt.intervals, segment.interval.start))

    dim = flt.dimension
    if dim in segment.dims:
        return LutNode(dim, _dictionary_lut(segment.dims[dim].dictionary,
                                            _string_predicate(flt)))
    if dim == "__time":
        colname, conv, narrow = "__time_offset", (
            lambda s: min(max(int(s) - segment.interval.start,
                              -(2**31) + 1), 2**31 - 2)), False
    elif dim in segment.metrics:
        vt = segment.metrics[dim].type
        colname = dim
        conv = int if vt == ValueType.LONG else float
        # constants outside int32 have constant outcomes on a column that
        # staged int32 (every value fits int32 — that is why it did)
        narrow = vt == ValueType.LONG \
            and segment.staged_dtype(dim) == np.int32
    else:
        # missing column: selector of null matches all rows, else none
        if isinstance(flt, F.SelectorFilter) and flt.value in (None, ""):
            return ConstNode(True)
        return ConstNode(False)

    def in_range(v):
        return not narrow or _I32_MIN <= v <= _I32_MAX

    if isinstance(flt, F.SelectorFilter):
        if flt.value is None:
            return ConstNode(False)
        v = conv(flt.value)
        return NumericEqNode(colname, v) if in_range(v) else ConstNode(False)
    if isinstance(flt, F.InFilter):
        vals = [conv(v) for v in flt.values if v is not None]
        vals = [v for v in vals if in_range(v)]
        return NumericInNode(colname, vals) if vals else ConstNode(False)
    if isinstance(flt, F.BoundFilter):
        lo = conv(flt.lower) if flt.lower is not None else None
        hi = conv(flt.upper) if flt.upper is not None else None
        if narrow:
            if (lo is not None and lo > _I32_MAX) \
                    or (hi is not None and hi < _I32_MIN):
                return ConstNode(False)
            if lo is not None and lo < _I32_MIN:
                lo = None
            if hi is not None and hi > _I32_MAX:
                hi = None
        if lo is None and hi is None:
            return ConstNode(True)
        return NumericCmpNode(colname, lo, hi, flt.lower_strict,
                              flt.upper_strict)
    raise NotImplementedError(
        f"filter {type(flt).__name__} on numeric column {dim!r}")


def _simplify(node: FilterNode) -> FilterNode:
    if isinstance(node, (AndNode, OrNode)):
        is_and = not isinstance(node, OrNode)
        kids = []
        for c in node.children:
            c = _simplify(c)
            if isinstance(c, ConstNode):
                if c.value != is_and:        # absorbing element
                    return ConstNode(c.value)
                continue                     # neutral element
            kids.append(c)
        if not kids:
            return ConstNode(is_and)
        return kids[0] if len(kids) == 1 else type(node)(kids)
    if isinstance(node, NotNode):
        c = _simplify(node.child)
        if isinstance(c, ConstNode):
            return ConstNode(not c.value)
        return NotNode(c)
    return node
