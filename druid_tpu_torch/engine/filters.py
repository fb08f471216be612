"""Filter planning: DimFilter trees -> row-mask programs over staged tensors.

The port's counterpart of the reference package's `engine/filters.py`.
String predicates are evaluated on the host against the dimension dictionary
into a boolean lookup table (LUT). Two device forms follow from it:
  * row domain: the predicate is one gather, `lut[ids]` (LutNode);
  * device bitmaps (on by default, `set_device_bitmap_enabled`): a maximal
    subtree of string predicates plans to one DeviceBitmapNode, an
    AND/OR/NOT word algebra over per-leaf row bitmaps. Staged, the algebra
    runs once per (segment, filter) into combined words cached on the
    segment, and the row mask is a bit test of those words; fused
    (engine/megakernel.py), the leaf words stay resident and the algebra
    runs inside the aggregation. A leaf's bits come from the dimension's
    bitmap index where the column holds one (a loaded segment's persisted
    index, or one built already): dense words, or sparse row ids expanded
    into words on the device; else from `lut[ids]`.
Numeric predicates compare the staged value column in its staged dtype, or
a virtual column in its output dtype. A columnComparison compares the
dimensions' ids remapped into one merged dictionary; an expression filter
evaluates on the device (utils/expression.py), its string-dimension
comparisons rewritten to dictionary LUT gathers. Constants are folded out
of the tree before any device work.

`bitmap_of`, `filter_cardinality` and `estimate_selectivity` are the
reference's host bitmap-index path: a bitmap-eligible filter evaluated by
bitmap algebra over the dimensions' indexes (built on first use).

The non-aggregate engines (scan, select, search, timeBoundary) take their
row mask from `host_mask`, which keeps the reference's host semantics leaf
by leaf (they differ from plan_filter's in places) as a bool tensor on the
query's device; having specs test result rows with
`evaluate_filter_on_row`.

Word layout, everywhere in the port: int32 words, LSB first — row r is bit
r % 32 of word r // 32 (the reference's staged filter-word layout,
`druid_tpu/data/bitmap.py` to_words32).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import re
import threading
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from druid_tpu_torch.data import cascade
from druid_tpu_torch.data.bitmap import (AnyBitmap, Bitmap, SparseBitmap,
                                         bitmap_and, bitmap_or, device_repr)
from druid_tpu_torch.data.dictionary import Dictionary, merge_dictionaries
from druid_tpu_torch.data.segment import Segment, ValueType
from druid_tpu_torch.obs import dispatch as dispatch_mod
from druid_tpu_torch.query import filters as F
from druid_tpu_torch.utils.emitter import Monitor
from druid_tpu_torch.utils.expression import (lut_for_site, parse_expression,
                                              rewrite_string_sites)

Cols = Dict[str, torch.Tensor]

#: process default for the device-bitmap filter path (on, as in the
#: reference); tests flip it with set_device_bitmap_enabled
_DEVICE_BITMAP = True
_DEVICE_BITMAP_LOCK = threading.Lock()


def set_device_bitmap_enabled(on: bool) -> bool:
    """Flip the process-wide device-bitmap default; returns the previous
    value."""
    global _DEVICE_BITMAP
    with _DEVICE_BITMAP_LOCK:
        prev = _DEVICE_BITMAP
        _DEVICE_BITMAP = bool(on)
        return prev


def device_bitmap_enabled() -> bool:
    return _DEVICE_BITMAP


class FilterNode:
    """A planned filter over one segment's staged columns."""

    def required_device_columns(self) -> Set[str]:
        return set()

    def signature(self) -> str:
        """The reference's structural signature (the run domain's plan and
        the batched path's bucket digest carry it)."""
        raise NotImplementedError

    def aux_arrays(self) -> List[np.ndarray]:
        """The node's constants, in the reference's order: plans whose
        structure matches batch together only where these are equal."""
        return []

    def build(self, cols: Cols) -> torch.Tensor:
        """The bool row mask; `cols` maps column name -> staged tensor."""
        raise NotImplementedError


class ConstNode(FilterNode):
    def __init__(self, value: bool):
        self.value = value

    def signature(self):
        return f"const({self.value})"

    def build(self, cols):
        v = cols["__valid"]
        return torch.full(v.shape, self.value, dtype=torch.bool,
                          device=v.device)


class LutNode(FilterNode):
    """mask = lut[ids] — every dictionary predicate reduces to this."""

    def __init__(self, dim: str, lut: np.ndarray):
        self.dim = dim
        self.lut = torch.from_numpy(lut.astype(bool))

    def signature(self):
        return f"lut({self.dim})"

    def aux_arrays(self):
        return [self.lut.numpy()]

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

    def signature(self):
        return (f"numcmp({self.column},{self.lower is not None},"
                f"{self.upper is not None},{self.lower_strict},"
                f"{self.upper_strict})")

    def aux_arrays(self):
        return [np.asarray(b) for b in (self.lower, self.upper)
                if b is not None]

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

    def signature(self):
        return f"numeq({self.column})"

    def aux_arrays(self):
        return [np.asarray(self.value)]

    def required_device_columns(self):
        return {self.column}

    def build(self, cols):
        v = cols[self.column]
        return v == torch.tensor(self.value, dtype=v.dtype, device=v.device)


class NumericInNode(FilterNode):
    def __init__(self, column: str, values: List):
        self.column = column
        self.values = values

    def signature(self):
        return f"numin({self.column},{len(self.values)})"

    def aux_arrays(self):
        return [np.asarray(self.values)]

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

    def signature(self):
        return f"timein({self.offsets.shape[0]})"

    def aux_arrays(self):
        return [self.offsets]

    def build(self, cols):
        return time_mask(cols["__time_offset"], self.offsets)


class ColumnCompareNode(FilterNode):
    """dimA == dimB row by row: each dimension's ids remap into one merged
    dictionary's ids, which then compare."""

    def __init__(self, dims: Tuple[str, ...], remaps: List[np.ndarray]):
        self.dims = dims
        self.remaps = remaps

    def signature(self):
        return f"colcmp({','.join(self.dims)})"

    def aux_arrays(self):
        return list(self.remaps)

    def required_device_columns(self):
        return set(self.dims)

    def build(self, cols):
        dev = cols["__valid"].device
        merged = [torch.from_numpy(r).to(dev)[cols[d].long()]
                  for d, r in zip(self.dims, self.remaps)]
        mask = torch.ones(cols["__valid"].shape, dtype=torch.bool,
                          device=dev)
        for other in merged[1:]:
            mask &= merged[0] == other
        return mask


class _Bindings:
    """An expression's bindings over staged columns, read one name at a
    time (iterating a DecodedView would decode every packed column):
    `extra` first (the LUTs, computed virtual columns), then the absolute
    `__time` (int64 offset + time0, built on first use), then `cols`."""

    def __init__(self, cols, time0: int, extra: Dict):
        self.cols, self.time0, self.extra = cols, time0, extra

    def __getitem__(self, name):
        if name not in self.extra and name == "__time":
            self.extra[name] = self.cols["__time_offset"].to(torch.int64) \
                + self.time0
        return self.extra[name] if name in self.extra else self.cols[name]

    def __contains__(self, name):
        return name in self.extra or name == "__time" or name in self.cols


def expression_bindings(cols, time0: int, luts: Sequence[np.ndarray]):
    """Bindings for evaluating an expression over staged columns: absolute
    `__time` and the string sites' LUTs on the columns' device."""
    dev = cols["__valid"].device
    return _Bindings(cols, time0, {
        "__luts": [torch.from_numpy(lut).to(dev) for lut in luts]})


class ExpressionNode(FilterNode):
    """Expression filter evaluated on the device (utils/expression.py).
    Comparisons of a string dimension with a literal are rewritten at plan
    time into per-dictionary-id LUT gathers (`rewrite_string_sites`), so
    only ids and numbers reach the device; any other use of a string
    dimension raises."""

    def __init__(self, expression: str, time0: int, segment: Segment):
        self.expression = expression
        self.time0 = time0
        self.expr, sites = rewrite_string_sites(
            parse_expression(expression), frozenset(segment.dims))
        self.luts = [lut_for_site(s, segment.dims[s[0]].dictionary.values)
                     for s in sites]

    def signature(self):
        return f"expr({self.expr!r};l{len(self.luts)})"

    def aux_arrays(self):
        return [np.asarray(self.time0, dtype=np.int64)] + list(self.luts)

    def required_device_columns(self):
        return set(self.expr.required_columns())

    def build(self, cols):
        out = self.expr.evaluate(expression_bindings(cols, self.time0,
                                                     self.luts))
        if torch.is_tensor(out):
            return out.to(torch.bool)
        v = cols["__valid"]
        return torch.full(v.shape, bool(out), dtype=torch.bool,
                          device=v.device)


class _NaryNode(FilterNode):
    def __init__(self, children: List[FilterNode]):
        self.children = children

    def required_device_columns(self):
        return set().union(*(c.required_device_columns()
                             for c in self.children))

    def aux_arrays(self):
        return [a for c in self.children for a in c.aux_arrays()]


class AndNode(_NaryNode):
    def signature(self):
        return "and(" + ",".join(c.signature() for c in self.children) + ")"

    def build(self, cols):
        mask = self.children[0].build(cols)
        for c in self.children[1:]:
            mask = mask & c.build(cols)
        return mask


class OrNode(_NaryNode):
    def signature(self):
        return "or(" + ",".join(c.signature() for c in self.children) + ")"

    def build(self, cols):
        mask = self.children[0].build(cols)
        for c in self.children[1:]:
            mask = mask | c.build(cols)
        return mask


class NotNode(FilterNode):
    def __init__(self, child: FilterNode):
        self.child = child

    def signature(self):
        return "not(" + self.child.signature() + ")"

    def aux_arrays(self):
        return self.child.aux_arrays()

    def required_device_columns(self):
        return self.child.required_device_columns()

    def build(self, cols):
        return ~self.child.build(cols)


class DeviceBitmapNode(FilterNode):
    """A bitmap-eligible filter subtree compiled to word algebra.

    `structure` is ("and"|"or", children) / ("not", child) / ("leaf", i) /
    ("const", bool); leaf i is `leaves[i]` = (dim, LUT). On the staged path
    stage_device_bitmaps evaluates the algebra once into combined words,
    cached on the segment under bitmap_pool_key and staged as `col`; build()
    bit-tests them. The node reads no segment column: a dimension that only
    the filter names is not staged."""

    def __init__(self, flt: F.DimFilter, segment: Segment):
        self.slot = 0                    # assigned by assign_bitmap_slots
        self.leaves: List[Tuple[str, np.ndarray]] = []
        self.structure = self._compile(flt, segment)

    def _compile(self, flt: F.DimFilter, segment: Segment):
        if isinstance(flt, F.TrueFilter):
            return ("const", True)
        if isinstance(flt, F.FalseFilter):
            return ("const", False)
        if isinstance(flt, F.AndFilter):
            return ("and", tuple(self._compile(f, segment)
                                 for f in flt.fields))
        if isinstance(flt, F.OrFilter):
            return ("or", tuple(self._compile(f, segment)
                                for f in flt.fields))
        if isinstance(flt, F.NotFilter):
            return ("not", self._compile(flt.field, segment))
        dim = flt.dimension
        self.leaves.append((dim, _dictionary_lut(segment.dims[dim].dictionary,
                                                 _string_predicate(flt))))
        return ("leaf", len(self.leaves) - 1)

    @property
    def col(self) -> str:
        return f"__fbmp{self.slot}"

    def signature(self):
        # the reduction reads only this slot's words: the full structure
        # keys the words' pool entry (structure_sig, digest) instead
        return f"devbmp({self.slot})"

    def structure_sig(self) -> str:
        def render(node):
            op = node[0]
            if op == "leaf":
                return f"leaf({self.leaves[node[1]][0]})"
            if op == "const":
                return f"const({node[1]})"
            if op == "not":
                return f"not({render(node[1])})"
            return f"{op}(" + ",".join(render(c) for c in node[1]) + ")"
        return render(self.structure)

    def digest(self) -> str:
        """Which dictionary ids each leaf matches: same structure, same
        digest and same segment give the same words."""
        h = hashlib.sha1(self.structure_sig().encode())
        for dim, lut in self.leaves:
            h.update(dim.encode())
            h.update(lut.tobytes())
        return h.hexdigest()[:20]

    def build(self, cols):
        return expand_mask_words(cols[self.col], cols["__valid"].shape[-1])


def collect_bitmap_nodes(node: Optional[FilterNode]
                         ) -> List[DeviceBitmapNode]:
    """Every DeviceBitmapNode in a planned tree, in DFS order."""
    out: List[DeviceBitmapNode] = []

    def walk(n):
        if isinstance(n, DeviceBitmapNode):
            out.append(n)
        elif isinstance(n, _NaryNode):
            for c in n.children:
                walk(c)
        elif isinstance(n, NotNode):
            walk(n.child)
    if node is not None:
        walk(node)
    return out


def item_bitmap_nodes(filter_node: Optional[FilterNode],
                      kernels: Sequence = ()) -> List[DeviceBitmapNode]:
    """The bitmap nodes of one execution: the query filter's, then every
    filtered aggregator's tree in kernel order (`AggKernel.filter_trees`)."""
    nodes = collect_bitmap_nodes(filter_node)
    for k in kernels:
        for tree in k.filter_trees():
            nodes.extend(collect_bitmap_nodes(tree))
    return nodes


def assign_bitmap_slots(filter_node: Optional[FilterNode],
                        kernels: Sequence = ()) -> int:
    """Unique slots (hence staged names `__fbmpN` and mega leaf names) for
    every bitmap node of one execution, in `item_bitmap_nodes` order: a
    filtered aggregator's tree, planned from slot 0, would otherwise stage
    its words under the query filter's names. Returns the slot count."""
    nodes = item_bitmap_nodes(filter_node, kernels)
    for slot, node in enumerate(nodes):
        node.slot = slot
    return len(nodes)


def perm_digest(perm_key) -> Optional[str]:
    """Stable digest of a row permutation's identity (the projection's
    cache key); None = the segment's own row order."""
    if perm_key is None:
        return None
    return hashlib.sha1(repr(perm_key).encode()).hexdigest()[:16]


def bitmap_pool_key(node: DeviceBitmapNode, padded_rows: int,
                    perm_dig: Optional[str], device: torch.device) -> Tuple:
    """THE segment cache key of a node's combined words: shared by
    stage_device_bitmaps and the megakernel's residency probe
    (megakernel.megaize), so the two cannot drift apart."""
    return ("fbmp", node.structure_sig(), node.digest(), padded_rows,
            perm_dig, str(device))


def leaf_digest(lut: np.ndarray) -> str:
    return hashlib.sha1(lut.tobytes()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# Mask words: one layout (row r = bit r % 32 of int32 word r // 32) for the
# staged combined words, the fused leaf words and kernel B2's row mask
# ---------------------------------------------------------------------------

def host_words(bits: np.ndarray) -> np.ndarray:
    """Host bool rows (length a multiple of 32) -> int32 words."""
    return np.packbits(bits, bitorder="little").view(np.int32)


def pack_mask_words(mask: torch.Tensor) -> torch.Tensor:
    """Bool rows -> int32 words; rows past the end pack as 0 bits. An OR
    fold of 32 shifted slices: the bits are disjoint, so it is exact, and
    it stays in int32 (a sum would widen to int64)."""
    pad = (-mask.shape[0]) % 32
    m = mask.to(torch.int32)
    if pad:
        m = torch.cat([m, m.new_zeros(pad)])
    planes = m.view(-1, 32).t().contiguous()     # [32, words]: bit planes
    words = planes[0].clone()
    for s in range(1, 32):
        words |= planes[s] << s
    return words


def expand_mask_words(words: torch.Tensor, rows: int) -> torch.Tensor:
    """int32 words [..., W] -> the first `rows` bool rows [..., rows] (a
    batched stack of words expands slot by slot)."""
    sh = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words[..., None] >> sh) & 1).flatten(-2)[..., :rows].bool()


def combine_structure_words(structure, leaf_words, const_words):
    """THE word-algebra evaluator, AND/OR/NOT over whatever
    `leaf_words(i)` / `const_words(bool)` return. The staged fill
    (_fill_single) and the fused path (megakernel.MegaBitmapNode.words)
    both evaluate through it (by structure_words), so their bits cannot
    differ."""
    def ev(node):
        op = node[0]
        if op == "leaf":
            return leaf_words(node[1])
        if op == "const":
            return const_words(node[1])
        if op == "not":
            return ~ev(node[1])
        kids = [ev(c) for c in node[1]]
        out = kids[0]
        for k in kids[1:]:
            out = (out & k) if op == "and" else (out | k)
        return out

    return ev(structure)


def structure_words(structure, leaf_words) -> torch.Tensor:
    """A bitmap node's combined int32 words from its leaves' words
    (`leaf_words(i)`); constants are full words shaped like leaf 0's (a
    bitmap node always has a leaf)."""
    ref = leaf_words(0)

    def const_words(value):
        return torch.full(ref.shape, -1 if value else 0, dtype=torch.int32,
                          device=ref.device)

    return combine_structure_words(structure, leaf_words, const_words)


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
    """Value-level predicate of a single-dimension string filter, or None
    for a filter that has none. An extraction_fn transforms each value
    before the predicate (None reads as "")."""
    ex = getattr(flt, "extraction_fn", None)
    if ex is not None:
        base = _string_predicate(dataclasses.replace(flt,
                                                     extraction_fn=None))
        if base is None:
            return None

        def extracted(v, _base=base, _ex=ex):
            out = _ex.apply(v)
            return _base("" if out is None else out)
        return extracted
    # a filter that tests each value itself (spatial) says how
    if hasattr(flt, "value_predicate"):
        return flt.value_predicate()
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
    if isinstance(flt, F.LikeFilter):
        rx = re.compile(flt.regex())
        return lambda v: rx.match(v) is not None
    if isinstance(flt, F.RegexFilter):
        rx = re.compile(flt.pattern)
        return lambda v: rx.search(v) is not None
    if isinstance(flt, F.SearchFilter):
        if flt.case_sensitive:
            return lambda v: flt.value in v
        needle = flt.value.lower()
        return lambda v: needle in v.lower()
    if isinstance(flt, F.JavaScriptFilter):
        return flt.predicate
    return None


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------

def plan_filter(flt: Optional[F.DimFilter], segment: Segment,
                virtual_columns: Sequence = (),
                device_bitmap: Optional[bool] = None
                ) -> Optional[FilterNode]:
    """Plan `flt` for `segment` and fold its constants: None (no filter),
    a ConstNode(False) root (nothing matches), or a constant-free tree.
    A numeric leaf on one of `virtual_columns` compares the computed column.
    device_bitmap: plan maximal bitmap-eligible subtrees to
    DeviceBitmapNodes (None = the process default)."""
    if flt is None:
        return None
    use_bitmap = device_bitmap_enabled() if device_bitmap is None \
        else device_bitmap
    vc_types = {v.name: v.output_type for v in virtual_columns}
    node = _simplify(_plan(flt.optimize(), segment, vc_types, use_bitmap))
    if isinstance(node, ConstNode) and node.value:
        return None
    assign_bitmap_slots(node)
    return node


_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1


def can_use_bitmap(flt: F.DimFilter, segment: Segment) -> bool:
    """Every leaf is a string predicate on a dimension of the segment."""
    if isinstance(flt, (F.TrueFilter, F.FalseFilter)):
        return True
    if isinstance(flt, (F.AndFilter, F.OrFilter)):
        return all(can_use_bitmap(f, segment) for f in flt.fields)
    if isinstance(flt, F.NotFilter):
        return can_use_bitmap(flt.field, segment)
    return getattr(flt, "dimension", None) in segment.dims \
        and _string_predicate(flt) is not None


# ---------------------------------------------------------------------------
# Host bitmap-index path (the reference's; Druid's Filter.getBitmapIndex)
# ---------------------------------------------------------------------------

def bitmap_of(flt: F.DimFilter, segment: Segment) -> AnyBitmap:
    """Evaluate a bitmap-eligible filter (`can_use_bitmap`) by bitmap
    algebra over the dimensions' bitmap indexes (data/bitmap.py). Results
    are density-adaptive: a sparse operand stays an id list through
    AND/OR; only a complement densifies."""
    n = segment.n_rows
    if isinstance(flt, F.TrueFilter):
        return Bitmap.full(n)
    if isinstance(flt, F.FalseFilter):
        return SparseBitmap(np.zeros(0, dtype=np.int32), n)
    if isinstance(flt, F.AndFilter):
        parts = [bitmap_of(f, segment) for f in flt.fields]
        return functools.reduce(bitmap_and, parts) if parts \
            else Bitmap.full(n)
    if isinstance(flt, F.OrFilter):
        parts = [bitmap_of(f, segment) for f in flt.fields]
        return functools.reduce(bitmap_or, parts) if parts \
            else SparseBitmap(np.zeros(0, dtype=np.int32), n)
    if isinstance(flt, F.NotFilter):
        return ~bitmap_of(flt.field, segment)
    col = segment.dims[flt.dimension]
    lut = _dictionary_lut(col.dictionary, _string_predicate(flt))
    return col.bitmap_index().union_of(np.flatnonzero(lut))


def filter_cardinality(flt: F.DimFilter, segment: Segment) -> int:
    """The exact count of rows a bitmap-eligible filter matches. NOT counts
    n - |child|, so a complement is never materialized."""
    n = segment.n_rows
    if isinstance(flt, F.TrueFilter):
        return n
    if isinstance(flt, F.FalseFilter):
        return 0
    if isinstance(flt, F.NotFilter):
        return n - filter_cardinality(flt.field, segment)
    return bitmap_of(flt, segment).cardinality()


def estimate_selectivity(flt: Optional[F.DimFilter],
                         segment: Segment) -> float:
    """The share of rows expected to match (Druid's
    Filter.estimateSelectivity); exact where the filter is
    bitmap-eligible, 1.0 elsewhere."""
    if flt is None:
        return 1.0
    if segment.n_rows == 0:
        return 0.0
    if can_use_bitmap(flt, segment):
        return filter_cardinality(flt, segment) / segment.n_rows
    return 1.0


def _bitmap_compilable(flt: F.DimFilter, segment: Segment) -> bool:
    """The whole subtree is bitmap material and names at least one
    dimension (a constant-only subtree folds to a ConstNode instead)."""
    if not can_use_bitmap(flt, segment):
        return False

    def has_leaf(f):
        if isinstance(f, (F.AndFilter, F.OrFilter)):
            return any(has_leaf(x) for x in f.fields)
        if isinstance(f, F.NotFilter):
            return has_leaf(f.field)
        return getattr(f, "dimension", None) in segment.dims
    return has_leaf(flt)


def _plan(flt: F.DimFilter, segment: Segment, vc_types: Dict[str, str],
          use_bitmap: bool = False) -> FilterNode:
    if isinstance(flt, F.TrueFilter):
        return ConstNode(True)
    if isinstance(flt, F.FalseFilter):
        return ConstNode(False)
    if use_bitmap and _bitmap_compilable(flt, segment):
        # a maximal eligible subtree is one node; mixed trees recurse
        return DeviceBitmapNode(flt, segment)
    if isinstance(flt, F.AndFilter):
        return AndNode([_plan(f, segment, vc_types, use_bitmap)
                        for f in flt.fields])
    if isinstance(flt, F.OrFilter):
        return OrNode([_plan(f, segment, vc_types, use_bitmap)
                       for f in flt.fields])
    if isinstance(flt, F.NotFilter):
        return NotNode(_plan(flt.field, segment, vc_types, use_bitmap))
    if isinstance(flt, F.IntervalFilter):
        if flt.dimension != "__time":
            raise ValueError("interval filter supported on __time only")
        return TimeIntervalsNode(
            interval_offsets(flt.intervals, segment.interval.start))
    if isinstance(flt, F.ColumnComparisonFilter):
        dicts = []
        for d in flt.dimensions:
            col = segment.dims.get(d)
            if col is None:
                raise ValueError(f"columnComparison on non-string dim {d!r}")
            dicts.append(col.dictionary)
        _, remaps = merge_dictionaries(dicts)
        return ColumnCompareNode(flt.dimensions, remaps)
    if isinstance(flt, F.ExpressionFilter):
        return ExpressionNode(flt.expression, segment.interval.start, segment)

    dim = getattr(flt, "dimension", None)
    if dim is None:
        raise ValueError(f"cannot plan filter {flt!r}")
    if dim in segment.dims:
        pred = _string_predicate(flt)
        if pred is None:
            raise ValueError(f"cannot plan string filter {flt!r}")
        return LutNode(dim, _dictionary_lut(segment.dims[dim].dictionary,
                                            pred))
    if getattr(flt, "extraction_fn", None) is not None:
        # numeric and time columns have no dictionary to transform
        raise ValueError(
            f"extractionFn filter on non-string column [{dim}]")
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
    elif dim in vc_types:
        # a virtual column compares in its output dtype
        colname, narrow = dim, False
        conv = int if vc_types[dim] == "long" else float
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
    raise ValueError(
        f"cannot plan filter {type(flt).__name__} on numeric column")


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


# ---------------------------------------------------------------------------
# Staged device bitmaps: combined words per (segment, filter), cached
# ---------------------------------------------------------------------------

class FilterBitmapStats:
    """hits / misses of the combined-words cache probe (a hit skips leaf
    staging and the algebra); built_bytes = the words built on misses."""

    def __init__(self):
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.built_bytes = 0

    def record(self, hit: bool, nbytes: int = 0) -> None:
        with self._lock:
            if hit:
                self.hits += 1
            else:
                self.misses += 1
                self.built_bytes += nbytes

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "builtBytes": self.built_bytes}


_FBMP_STATS = FilterBitmapStats()


def filter_bitmap_stats() -> FilterBitmapStats:
    return _FBMP_STATS


class FilterBitmapMonitor(Monitor):
    """Emits query/filter/{deviceBitmapHits,deviceBitmapMisses,bytes} per
    tick (deltas over the tick window, the DevicePoolMonitor discipline)."""

    def __init__(self, source: Optional[FilterBitmapStats] = None):
        self.source = source or _FBMP_STATS
        self._last = self.source.snapshot()

    def do_monitor(self, emitter):
        s = self.source.snapshot()
        last, self._last = self._last, s
        emitter.metric("query/filter/deviceBitmapHits",
                       s["hits"] - last["hits"])
        emitter.metric("query/filter/deviceBitmapMisses",
                       s["misses"] - last["misses"])
        emitter.metric("query/filter/bytes",
                       s["builtBytes"] - last["builtBytes"])


def _permuted_bitmap(segment: Segment, bm: AnyBitmap, perm: np.ndarray,
                     perm_key) -> AnyBitmap:
    """A row bitmap in a permuted (projection) row order. A sparse bitmap
    stays sparse: its ids map through the inverse permutation, cached on
    the segment per perm_key."""
    if not isinstance(bm, SparseBitmap):
        return Bitmap.from_bool(bm.to_bool()[perm])

    def _inverse():
        inv = np.empty(perm.shape[0], dtype=np.int32)
        inv[perm] = np.arange(perm.shape[0], dtype=np.int32)
        return inv
    inv = _inverse() if perm_key is None else segment.aux_cached(
        ("perm_inv", perm_digest(perm_key)), _inverse)
    return SparseBitmap(np.sort(inv[bm.ids]), bm.n_rows)


def leaf_bitmap(segment: Segment, dim: str, lut: np.ndarray,
                perm: Optional[np.ndarray] = None,
                perm_key=None) -> Optional[AnyBitmap]:
    """A leaf's rows from the bitmap index the column holds (persisted, as a
    loaded segment's, or built already), in the permuted order where `perm`
    is given; None where the column holds no index. No index is built for a
    leaf: that is a stable argsort of the whole column."""
    index = segment.dims[dim].held_bitmap_index()
    if index is None:
        return None
    bm = index.union_of(np.flatnonzero(lut))
    return bm if perm is None \
        else _permuted_bitmap(segment, bm, perm, perm_key)


def leaf_bits(segment: Segment, dim: str, lut: np.ndarray, rows: int,
              perm: Optional[np.ndarray] = None,
              perm_key=None) -> np.ndarray:
    """A leaf's row bitmap as host bools, padded with False to `rows`, in
    the permuted (projection) row order where `perm` is given: from the
    column's bitmap index where it holds one (`leaf_bitmap`), else
    `lut[ids]`. The bits are the same either way."""
    bm = leaf_bitmap(segment, dim, lut, perm, perm_key)
    if bm is not None:
        b = bm.to_bool()
    else:
        b = lut[segment.dims[dim].ids]
        if perm is not None:
            b = b[perm]
    out = np.zeros(rows, dtype=bool)
    out[: b.shape[0]] = b
    return out


def leaf_repr(segment: Segment, dim: str, lut: np.ndarray, padded_rows: int,
              perm: Optional[np.ndarray] = None, perm_key=None
              ) -> Tuple[str, np.ndarray]:
    """(kind, host payload) a leaf ships to the device: from the column's
    bitmap index, `bitmap.device_repr`'s density split -- "sparse" (sorted
    row ids padded to a power of two with the sentinel `padded_rows`) or
    "dense" (uint32 words); where the column holds no index, "rows" (the
    words of `lut[ids]`)."""
    bm = leaf_bitmap(segment, dim, lut, perm, perm_key)
    if bm is not None:
        return device_repr(bm, padded_rows)
    return "rows", host_words(leaf_bits(segment, dim, lut, padded_rows,
                                        perm))


def sparse_leaf_words(ids: torch.Tensor, padded_rows: int) -> torch.Tensor:
    """int32 words [padded_rows / 32] with the bits of `ids` set, built on
    ids' device: distinct sorted row ids, padded with the sentinel
    `padded_rows`, which lands in a dropped extra word. The bits of one
    word are distinct, so their sum is their OR (exact in int64); the
    int64 word folds back to its int32 bit pattern."""
    n_words = padded_rows // 32
    acc = torch.zeros(n_words + 1, dtype=torch.int64, device=ids.device)
    wid = (ids >> 5).to(torch.int64)
    acc.index_add_(0, wid, torch.ones_like(wid) << (ids & 31).to(torch.int64))
    acc = acc[:n_words]
    return (acc - ((acc >> 31) & 1) * (1 << 32)).to(torch.int32)


def leaf_words(segment: Segment, dim: str, lut: np.ndarray, padded_rows: int,
               device: torch.device, perm: Optional[np.ndarray] = None,
               perm_key=None) -> torch.Tensor:
    """A leaf's row bitmap as int32 words [padded_rows / 32] on `device`,
    cached on the segment per (dim, LUT, rows, permutation, device). The
    one staging of leaf bits: the staged fill and the fused path
    (megakernel.stage_mega_leaves) read it where they do not build the
    leaf from run tables. A sparse leaf uploads its padded row ids and
    expands them on the device (`sparse_leaf_words`); a dense one uploads
    its words."""
    key = ("leafwords", dim, leaf_digest(lut), padded_rows,
           perm_digest(perm_key), str(device))

    def _build():
        kind, payload = leaf_repr(segment, dim, lut, padded_rows, perm,
                                  perm_key)
        if kind == "sparse":
            return sparse_leaf_words(torch.from_numpy(payload).to(device),
                                     padded_rows)
        return torch.from_numpy(payload.view(np.int32)).to(device)
    return segment.device_cached(key, _build)


#: a run leaf's end past every row: the sentinel run that covers padding
RUN_END_SENTINEL = 2**31 - 1


def _run_leaf_payload(segment: Segment, dim: str, lut: np.ndarray,
                      padded_rows: int) -> Optional[np.ndarray]:
    """A leaf as a run table, int32 [pad_pow2(runs + 1), 2] of (exclusive
    run end, the run's match), when `dim` has at most padded_rows / 256
    runs (well under the padded_rows / 32 words of the row-built leaf);
    else None (and None with the cascade off, as in the reference). The
    match is decided once per run; a sentinel run (end 2^31 - 1, match 0)
    covers the padding rows."""
    if not cascade.enabled():
        return None
    info = cascade.column_run_info(segment, dim, max_runs=padded_rows // 256)
    if info is None:
        return None
    values, ends, nr = info
    payload = np.zeros((cascade.pad_pow2(nr + 1), 2), dtype=np.int32)
    payload[:, 0] = RUN_END_SENTINEL
    payload[:nr, 0] = ends
    payload[:nr, 1] = lut[values]
    return payload


def runs_leaf_words(payload: torch.Tensor, padded_rows: int) -> torch.Tensor:
    """A run table's rows as int32 words [padded_rows / 32], on its device:
    each row finds its run among the exclusive ends and takes its match."""
    ends = payload[:, 0].contiguous()
    rows = torch.arange(padded_rows, dtype=torch.int32, device=ends.device)
    idx = torch.searchsorted(ends, rows, right=True) \
        .clamp_(0, ends.shape[0] - 1)
    return pack_mask_words(payload[:, 1][idx] > 0)


def _fill_leaf_words(segment: Segment, dim: str, lut: np.ndarray,
                     padded_rows: int, device: torch.device,
                     perm: Optional[np.ndarray], perm_key) -> torch.Tensor:
    """One leaf's words for the staged fill: expanded on the card from its
    run table (cached on the segment under its own key) where the rows keep
    their order and `dim` has few enough runs, else the row-built words."""
    payload = None if perm is not None \
        else _run_leaf_payload(segment, dim, lut, padded_rows)
    if payload is None:
        return leaf_words(segment, dim, lut, padded_rows, device, perm,
                          perm_key)
    key = ("fbmpleaf", dim, leaf_digest(lut), padded_rows, "runs",
           payload.shape[0], str(device))
    table = segment.device_cached(
        key, lambda: torch.from_numpy(payload).to(device))
    return runs_leaf_words(table, padded_rows)


def _fill_single(segment: Segment, node: DeviceBitmapNode, padded_rows: int,
                 device: torch.device, perm: Optional[np.ndarray] = None,
                 perm_key=None) -> torch.Tensor:
    """One (segment, filter) fill: the node's combined words."""
    words = [_fill_leaf_words(segment, dim, lut, padded_rows, device, perm,
                              perm_key) for dim, lut in node.leaves]
    out = structure_words(node.structure, words.__getitem__)
    dispatch_mod.record("filterFill")
    return out


def stage_device_bitmaps(segment: Segment, filter_node: Optional[FilterNode],
                         padded_rows: int, device: torch.device,
                         perm: Optional[np.ndarray] = None,
                         perm_key=None, kernels: Sequence = ()
                         ) -> Dict[str, torch.Tensor]:
    """{node.col: int32 words [padded_rows / 32]} for every DeviceBitmapNode
    of the query filter and of the kernels' filter trees, cached on the
    segment under bitmap_pool_key; with `perm`, the words are in the
    permuted row order, under their own key. The batched path stages a
    whole chunk's words in one wave (`stage_device_bitmaps_multi`)."""
    pdg = perm_digest(perm_key)
    out: Dict[str, torch.Tensor] = {}
    for node in item_bitmap_nodes(filter_node, kernels):
        key = bitmap_pool_key(node, padded_rows, pdg, device)
        hit = segment.device_contains(key)
        _FBMP_STATS.record(hit, 0 if hit else padded_rows // 8)
        out[node.col] = segment.device_cached(
            key, lambda n=node: _fill_single(segment, n, padded_rows, device,
                                             perm, perm_key))
    return out


def stage_device_bitmaps_multi(items: Sequence[Tuple], padded_rows: int,
                               device: torch.device
                               ) -> List[Dict[str, torch.Tensor]]:
    """The words of a whole batched chunk in one wave: one {node.col: int32
    words [padded_rows / 32]} dict per item (segment, filter_node, kernels),
    for the query filter's and every filtered aggregator's bitmap nodes of
    each plan, pooled per segment under bitmap_pool_key. A resident entry
    is a hit; a (segment, key) pair that occurs twice in the wave is built
    once and counts as a hit the second time. The misses are built
    together: every pending node's leaves, then each distinct structure's
    word algebra evaluated once over its nodes' stacked leaves."""
    out: List[Dict[str, torch.Tensor]] = [{} for _ in items]
    pending = []                  # (slot, segment, node, key)
    wave_dups: Dict[Tuple, List[Tuple[int, str]]] = {}
    for i, (segment, filter_node, kernels) in enumerate(items):
        for node in item_bitmap_nodes(filter_node, kernels):
            key = bitmap_pool_key(node, padded_rows, None, device)
            wkey = (id(segment), key)
            if wkey in wave_dups:
                _FBMP_STATS.record(True)
                wave_dups[wkey].append((i, node.col))
                continue
            hit = segment.device_contains(key)
            _FBMP_STATS.record(hit, 0 if hit else padded_rows // 8)
            if hit:
                # an eviction racing the probe rebuilds here, alone
                out[i][node.col] = segment.device_cached(
                    key, lambda s=segment, n=node: _fill_single(
                        s, n, padded_rows, device))
            else:
                wave_dups[wkey] = []
                pending.append((i, segment, node, key))
    by_structure: Dict[Tuple, List] = {}
    for p in pending:
        by_structure.setdefault(p[2].structure, []).append(p)
    for structure, group in by_structure.items():
        leaves = [[_fill_leaf_words(seg, dim, lut, padded_rows, device,
                                    None, None) for dim, lut in node.leaves]
                  for _, seg, node, _ in group]
        if len(group) == 1:
            words = [structure_words(structure, leaves[0].__getitem__)]
        else:
            stacked = [torch.stack(ws) for ws in zip(*leaves)]
            combined = structure_words(structure, stacked.__getitem__)
            # each slot's words own their storage, so the pool's count of
            # an entry is what evicting it frees
            words = [w.clone() for w in combined.unbind(0)]
        for (i, segment, node, key), w in zip(group, words):
            resident = segment.device_cached(key, lambda w=w: w)
            out[i][node.col] = resident
            for j, col in wave_dups[(id(segment), key)]:
                out[j][col] = resident
    if pending:
        dispatch_mod.record("filterFill")       # one wave
    return out


def _bind_string_dims(expr, segment: Segment, bindings: Dict) -> None:
    """Bind every string dimension `expr` references as its DECODED value
    array (object dtype), for host evaluation with numpy: string
    comparisons then follow the reference's lexicographic semantics
    directly."""
    for c in expr.required_columns():
        if c in segment.dims and c not in bindings:
            col = segment.dims[c]
            vals = np.asarray(list(col.dictionary.values), dtype=object)
            bindings[c] = vals[col.ids]


# ---------------------------------------------------------------------------
# Row-level evaluation (having specs over result rows)
# ---------------------------------------------------------------------------

def evaluate_filter_on_row(flt: F.DimFilter, row: Dict[str, object]) -> bool:
    """A filter over one result row: every leaf tests the row's value as a
    string (None reads as "")."""
    if isinstance(flt, F.TrueFilter):
        return True
    if isinstance(flt, F.FalseFilter):
        return False
    if isinstance(flt, F.AndFilter):
        return all(evaluate_filter_on_row(f, row) for f in flt.fields)
    if isinstance(flt, F.OrFilter):
        return any(evaluate_filter_on_row(f, row) for f in flt.fields)
    if isinstance(flt, F.NotFilter):
        return not evaluate_filter_on_row(flt.field, row)
    pred = _string_predicate(flt)
    if pred is None:
        raise ValueError(f"cannot row-evaluate {flt!r}")
    v = row.get(flt.dimension)
    return pred("" if v is None else str(v))


def make_row_matcher(flt: F.DimFilter):
    """Compile a DimFilter into row(dict)->bool over raw (pre-dictionary)
    values, for ingest-time TransformSpec filters (ingest/input.py), the
    analog of the reference's ValueMatcher for rows that are not yet
    columnar. Dims are strings (None ≡ ""), metrics numeric, __time
    millis. The reference package's `make_row_matcher`, leaf by leaf."""
    if isinstance(flt, F.TrueFilter):
        return lambda row: True
    if isinstance(flt, F.FalseFilter):
        return lambda row: False
    if isinstance(flt, F.AndFilter):
        subs = [make_row_matcher(f) for f in flt.fields]
        return lambda row: all(m(row) for m in subs)
    if isinstance(flt, F.OrFilter):
        subs = [make_row_matcher(f) for f in flt.fields]
        return lambda row: any(m(row) for m in subs)
    if isinstance(flt, F.NotFilter):
        sub = make_row_matcher(flt.field)
        return lambda row: not sub(row)
    if isinstance(flt, F.IntervalFilter):
        ivs = flt.intervals
        col = flt.dimension

        def iv_match(row):
            v = row.get(col)
            if v is None:
                return False
            try:
                ms = int(float(v))
            except (TypeError, ValueError):
                return False
            return any(iv.contains(ms) for iv in ivs)
        return iv_match
    if isinstance(flt, F.ColumnComparisonFilter):
        dims = flt.dimensions

        def cc_match(row):
            vals = [("" if row.get(d) is None else str(row.get(d)))
                    for d in dims]
            return all(v == vals[0] for v in vals)
        return cc_match
    if isinstance(flt, F.ExpressionFilter):
        expr = parse_expression(flt.expression)

        def ex_match(row):
            # None ≡ "" — the same null contract as every other row matcher.
            # A numeric expr over a null-bound column raises (e.g. "" > 2);
            # such rows simply don't match, as in the reference.
            try:
                out = expr.evaluate({k: ("" if v is None else v)
                                     for k, v in row.items()})
            except (TypeError, ValueError):
                return False
            try:
                return bool(float(out))
            except (TypeError, ValueError):
                return bool(out)
        return ex_match
    pred = _string_predicate(flt)
    if pred is not None:
        dim = flt.dimension

        def s_match(row):
            v = row.get(dim)
            return pred("" if v is None else str(v))
        return s_match
    raise ValueError(f"cannot row-match filter {type(flt).__name__}")


# ---------------------------------------------------------------------------
# The row mask of the non-aggregate engines (scan, select, search,
# timeBoundary), with the reference's host_mask semantics leaf by leaf
# ---------------------------------------------------------------------------

_CMP = {"==": torch.eq, "<": torch.lt, "<=": torch.le, ">": torch.gt,
        ">=": torch.ge}


def compare_scalar(vals: torch.Tensor, op: str, c) -> torch.Tensor:
    """`vals <op> c` for a Python number `c`. An integer column compares
    exactly whatever c's range (torch wraps a scalar outside the dtype);
    a float column compares in its own dtype, as numpy does with a Python
    float."""
    if not vals.is_floating_point():
        info = torch.iinfo(vals.dtype)
        if not info.min <= c <= info.max:
            above = c > info.max
            const = {"==": False, "<": above, "<=": above, ">": not above,
                     ">=": not above}[op]
            return torch.full(vals.shape, const, dtype=torch.bool,
                              device=vals.device)
    return _CMP[op](vals, c)


def _host_bindings(segment: Segment) -> Dict[str, np.ndarray]:
    """An expression's host bindings: `__time` and every metric's values."""
    bindings = {"__time": segment.time_ms}
    for name, m in segment.metrics.items():
        bindings[name] = m.values
    return bindings


def host_mask(flt: Optional[F.DimFilter], segment: Segment,
              virtual_columns: Sequence = (),
              device: torch.device = torch.device("cpu"),
              intervals: Optional[Sequence] = None) -> torch.Tensor:
    """The rows of `segment` that pass `flt` (and, where given, lie in
    `intervals`), a bool [n_rows] tensor on `device`."""
    return masked_columns(flt, segment, virtual_columns, device,
                          intervals)[0]


def masked_columns(flt: Optional[F.DimFilter], segment: Segment,
                   virtual_columns: Sequence = (),
                   device: torch.device = torch.device("cpu"),
                   intervals: Optional[Sequence] = None,
                   columns: Sequence[str] = ()):
    """(mask, cols): host_mask's mask, and the staged `__time_offset` and
    `columns` it was computed beside ({name: [n_rows] tensor}), from one
    staged block.

    The mask has the reference's host_mask semantics leaf by leaf. String
    leaves gather a dictionary LUT by the staged id column; numeric leaves
    compare the staged column (`__time` as its int32 offset); and/or/not
    combine tensors. Virtual columns and expression filters are evaluated
    on the host with numpy over the segment's host columns (int64 longs,
    string dimensions decoded by `_bind_string_dims`), as the reference
    evaluates them, and what they give is copied to the device once."""
    n = segment.n_rows
    vc_arrays: Dict[str, np.ndarray] = {}
    if flt is not None:
        flt = flt.optimize()
        if virtual_columns:
            bindings = _host_bindings(segment)
            for v in virtual_columns:
                expr = parse_expression(v.expression)
                _bind_string_dims(expr, segment, bindings)
                arr = np.broadcast_to(np.asarray(expr.evaluate(bindings)),
                                      (n,))
                vc_arrays[v.name] = bindings[v.name] = arr
    staged = set(columns)
    if flt is not None:
        staged |= _staged_columns(flt, segment, vc_arrays)
    block = segment.device_block(sorted(staged), device)
    # the dense view: an encoded column decodes on the card here
    _, view = cascade.split_resident(block.arrays)
    cols = {c: view[c][:n] for c in sorted(staged) + ["__time_offset"]}
    mask = torch.ones(n, dtype=torch.bool, device=device) if flt is None \
        else _host_mask(flt, segment, cols, vc_arrays, device)
    if intervals is not None:
        mask &= _in_intervals(cols["__time_offset"], segment.interval.start,
                              intervals)
    return mask, cols


def _in_intervals(off: torch.Tensor, t0: int, intervals) -> torch.Tensor:
    """Rows whose time (`t0` + int32 offset) lies in any interval."""
    inside = torch.zeros(off.shape, dtype=torch.bool, device=off.device)
    for iv in intervals:
        inside |= compare_scalar(off, ">=", iv.start - t0) \
            & compare_scalar(off, "<", iv.end - t0)
    return inside


def _staged_columns(flt: F.DimFilter, segment: Segment,
                    vc_arrays: Dict[str, np.ndarray]) -> Set[str]:
    """The segment columns `_host_mask` reads on the device."""
    if isinstance(flt, (F.AndFilter, F.OrFilter)):
        return set().union(*(_staged_columns(f, segment, vc_arrays)
                             for f in flt.fields))
    if isinstance(flt, F.NotFilter):
        return _staged_columns(flt.field, segment, vc_arrays)
    if isinstance(flt, F.ColumnComparisonFilter):
        return set(flt.dimensions)
    if isinstance(flt, F.IntervalFilter):
        return set()
    dim = getattr(flt, "dimension", None)
    return {dim} if dim in segment.dims or dim in segment.metrics else set()


def _host_mask(flt: F.DimFilter, segment: Segment,
               cols: Dict[str, torch.Tensor],
               vc_arrays: Dict[str, np.ndarray],
               device: torch.device) -> torch.Tensor:
    n = segment.n_rows

    def const(value: bool) -> torch.Tensor:
        return torch.full((n,), value, dtype=torch.bool, device=device)

    def rec(f):
        return _host_mask(f, segment, cols, vc_arrays, device)

    if isinstance(flt, (F.TrueFilter, F.FalseFilter)):
        return const(isinstance(flt, F.TrueFilter))
    if isinstance(flt, (F.AndFilter, F.OrFilter)):
        out = rec(flt.fields[0])
        for f in flt.fields[1:]:
            out = out & rec(f) if isinstance(flt, F.AndFilter) \
                else out | rec(f)
        return out
    if isinstance(flt, F.NotFilter):
        return ~rec(flt.field)
    t0 = segment.interval.start
    if isinstance(flt, F.IntervalFilter):
        return _in_intervals(cols["__time_offset"], t0, flt.intervals)
    if isinstance(flt, F.ColumnComparisonFilter):
        dicts = [segment.dims[d].dictionary for d in flt.dimensions]
        _, remaps = merge_dictionaries(dicts)
        merged = [torch.from_numpy(r).to(device)[cols[d].long()]
                  for d, r in zip(flt.dimensions, remaps)]
        out = const(True)
        for other in merged[1:]:
            out &= merged[0] == other
        return out
    if isinstance(flt, F.ExpressionFilter):
        expr = parse_expression(flt.expression)
        bindings = _host_bindings(segment)
        _bind_string_dims(expr, segment, bindings)
        bindings.update(vc_arrays)
        out = np.broadcast_to(np.asarray(expr.evaluate(bindings), dtype=bool),
                              (n,))
        return torch.from_numpy(np.array(out)).to(device)

    dim = getattr(flt, "dimension", None)
    if dim in segment.dims:
        pred = _string_predicate(flt)
        if pred is None:
            raise ValueError(f"cannot host-evaluate {flt!r}")
        lut = torch.from_numpy(_dictionary_lut(segment.dims[dim].dictionary,
                                               pred)).to(device)
        return lut[cols[dim].long()]
    if dim == "__time":
        vals, shift, conv = cols["__time_offset"], t0, int
    elif dim in segment.metrics:
        vals, shift = cols[dim], 0
        conv = int if segment.metrics[dim].type == ValueType.LONG else float
    elif dim in vc_arrays:
        # a virtual column's host values, copied once (a bool result
        # compares as numbers, as numpy promotes it)
        arr = vc_arrays[dim]
        conv = int if np.issubdtype(arr.dtype, np.integer) else float
        vals, shift = torch.from_numpy(np.array(
            arr, dtype=np.float64 if arr.dtype == bool else arr.dtype)
        ).to(device), 0
    else:
        # missing column: a selector of null matches every row, else none
        return const(isinstance(flt, F.SelectorFilter)
                     and flt.value in (None, ""))
    if isinstance(flt, F.SelectorFilter):
        if flt.value is None:
            return const(False)
        return compare_scalar(vals, "==", conv(flt.value) - shift)
    if isinstance(flt, F.InFilter):
        targets = [conv(v) - shift for v in flt.values if v is not None]
        if vals.is_floating_point():
            # numpy's isin compares a float32 column in float64
            return torch.isin(vals.to(torch.float64),
                              torch.tensor(targets, dtype=torch.float64,
                                           device=device))
        info = torch.iinfo(vals.dtype)
        targets = [t for t in targets if info.min <= t <= info.max]
        return torch.isin(vals, torch.tensor(targets, dtype=vals.dtype,
                                             device=device))
    if isinstance(flt, F.BoundFilter):
        out = const(True)
        if flt.lower is not None:
            out &= compare_scalar(vals, ">" if flt.lower_strict else ">=",
                                  conv(flt.lower) - shift)
        if flt.upper is not None:
            out &= compare_scalar(vals, "<" if flt.upper_strict else "<=",
                                  conv(flt.upper) - shift)
        return out
    raise ValueError(f"cannot host-evaluate {type(flt).__name__} on numeric")
