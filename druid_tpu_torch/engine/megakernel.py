"""The fused bitmap-filter path: leaf words resident, the word algebra inside
the aggregation, and kernel B2 reading the row mask as bits.

The port's counterpart of the reference package's `engine/megakernel.py`.
`megaize` turns each planned DeviceBitmapNode whose combined words are not
already cached on the segment into a MegaBitmapNode: its leaves' row
bitmaps stage as resident words (`stage_mega_leaves`; built once per run
where the dimension has run tables) and its AND/OR/NOT
algebra runs in the query's own pass (`MegaBitmapNode.words`, through
filters.combine_structure_words) instead of a separate fill.
`megaize_kernels` does the same to every filtered aggregator's tree; those
words always expand to bool rows, since such a plan is "mixed".

On the sorted-projection strategy, when the tree's root or its top-level AND
conjuncts are mega nodes (`split_for_kernel`), the query takes the
"megakernel" strategy: the base row mask (valid ∧ intervals ∧ residual
filter) packs to words, ANDs with each mega node's words, and `mega_reduce`
reduces with kernel B2 (csrc/sorted_reduce.cu, `sr_partial_words`), which
replaces the TPU kernel `megakernel.mega_reduce` (pl.pallas_call at
megakernel.py:742). On any other strategy a mega node expands its words to
bool rows (`MegaBitmapNode.build`).

* `mega_reduce` is the entry point: CPU tensors go to `mega_reduce_plain`
  (the words expanded to bools, then `sorted_reduce_plain`), CUDA tensors to
  `mega_reduce_cuda` (kernel B2), or the call raises.
* `LAUNCHES` counts B2's launches (one per `mega_reduce_cuda` call, both
  passes); `PLAIN_CALLS` the CPU calls routed to the plain version.

The mask bits are those of the staged path and B2 sums in B1's order, so
the fused, staged and row-domain paths give the same bits, floats included.
The reference's donated carry grids are JAX buffer donation and have no
counterpart here: PyTorch's caching allocator reuses a freed grid's memory.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from druid_tpu_torch.data import cascade
from druid_tpu_torch.engine import sorted_reduce as sorted_reduce_mod
from druid_tpu_torch.engine.filters import (AndNode, DeviceBitmapNode,
                                            FilterNode, NotNode, OrNode,
                                            bitmap_pool_key,
                                            collect_bitmap_nodes,
                                            expand_mask_words, host_words,
                                            item_bitmap_nodes, leaf_digest,
                                            leaf_words,
                                            pack_mask_words, structure_words)
from druid_tpu_torch.utils.emitter import Monitor

#: launches of kernel B2 in this process (the chip smoke resets it)
LAUNCHES = 0
#: calls that `mega_reduce` routed to the plain version (CPU tensors)
PLAIN_CALLS = 0
#: guards both counts: the broker's scatter threads launch concurrently
COUNT_LOCK = threading.Lock()

#: process default (on, as in the reference); tests flip it with set_enabled
_ENABLED = True
_STATE_LOCK = threading.Lock()


def set_enabled(on: bool) -> bool:
    """Flip the process-wide megakernel default; returns the previous
    value. Off, bitmap subtrees stay on the staged combined-words path."""
    global _ENABLED
    with _STATE_LOCK:
        prev = _ENABLED
        _ENABLED = bool(on)
        return prev


def enabled() -> bool:
    return _ENABLED


class MegaStats:
    """hits = bitmap subtrees fused; fallbacks = bitmap subtrees left on
    the staged path (megakernel off, or their combined words cached)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.hits = 0
        self.fallbacks = 0

    def record_hit(self, n: int = 1) -> None:
        with self._lock:
            self.hits += n

    def record_fallback(self, n: int = 1) -> None:
        with self._lock:
            self.fallbacks += n

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "fallbacks": self.fallbacks}


_STATS = MegaStats()


def stats() -> MegaStats:
    return _STATS


class MegakernelMonitor(Monitor):
    """Emits query/megakernel/{hits,fallbacks,donatedBytes} per tick
    (deltas over the tick window, the FilterBitmapMonitor discipline).
    The port donates no carries, so donatedBytes is always 0: the metric
    stays so that dashboards read the reference's names."""

    def __init__(self, source: Optional[MegaStats] = None):
        self.source = source or _STATS
        self._last = self.source.snapshot()

    def do_monitor(self, emitter):
        s = self.source.snapshot()
        last, self._last = self._last, s
        emitter.metric("query/megakernel/hits", s["hits"] - last["hits"])
        emitter.metric("query/megakernel/fallbacks",
                       s["fallbacks"] - last["fallbacks"])
        emitter.metric("query/megakernel/donatedBytes", 0)


class MegaBitmapNode(FilterNode):
    """A bitmap-eligible subtree fused into the aggregation: its leaves are
    resident words (`leaf_col(j)`), its algebra runs per query."""

    def __init__(self, structure, leaves: List[Tuple[str, np.ndarray]],
                 slot: int):
        self.structure = structure
        self.leaves = leaves
        self.slot = slot

    @classmethod
    def from_bitmap(cls, node: DeviceBitmapNode) -> "MegaBitmapNode":
        return cls(node.structure, list(node.leaves), node.slot)

    # the staged node's rendering and digest: one key contract
    structure_sig = DeviceBitmapNode.structure_sig
    digest = DeviceBitmapNode.digest

    def leaf_col(self, j: int) -> str:
        return f"__fleaf{self.slot}_{j}"

    def words(self, cols: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The combined int32 mask words, from the staged leaf words."""
        return structure_words(self.structure,
                               lambda i: cols[self.leaf_col(i)])

    def build(self, cols):
        # off the kernel path (the mixed strategy, or under OR/NOT): the
        # words expand to bool rows
        return expand_mask_words(self.words(cols), cols["__valid"].shape[0])


def collect_mega_nodes(node: Optional[FilterNode]) -> List[MegaBitmapNode]:
    """Every MegaBitmapNode in a planned tree, in DFS order."""
    out: List[MegaBitmapNode] = []

    def walk(n):
        if isinstance(n, MegaBitmapNode):
            out.append(n)
        elif isinstance(n, (AndNode, OrNode)):
            for c in n.children:
                walk(c)
        elif isinstance(n, NotNode):
            walk(n.child)
    if node is not None:
        walk(node)
    return out


def split_for_kernel(node: Optional[FilterNode]
                     ) -> Tuple[List[MegaBitmapNode], Optional[FilterNode]]:
    """(mega nodes that are the root or top-level AND conjuncts, the
    residual row-domain tree). Only those combine with the base mask in the
    word domain; a mega node under OR/NOT stays in the residual and expands
    to bools there. The residual keeps the children's order."""
    if node is None:
        return [], None
    if isinstance(node, MegaBitmapNode):
        return [node], None
    if isinstance(node, AndNode):
        megas = [c for c in node.children if isinstance(c, MegaBitmapNode)]
        rest = [c for c in node.children
                if not isinstance(c, MegaBitmapNode)]
        if not megas:
            return [], node
        residual = None if not rest else \
            rest[0] if len(rest) == 1 else AndNode(rest)
        return megas, residual
    return [], node


def megaize(filter_node: Optional[FilterNode], segment, padded_rows: int,
            device: torch.device,
            perm_dig: Optional[str] = None) -> Optional[FilterNode]:
    """The tree with every DeviceBitmapNode whose combined words are not
    cached on the segment replaced by a MegaBitmapNode. Cached combined
    words (from a staged run) keep the bit-test path."""
    if filter_node is None or not collect_bitmap_nodes(filter_node):
        return filter_node

    def rebuild(n):
        if isinstance(n, DeviceBitmapNode):
            if segment.device_contains(bitmap_pool_key(n, padded_rows,
                                                       perm_dig, device)):
                _STATS.record_fallback()
                return n
            _STATS.record_hit()
            return MegaBitmapNode.from_bitmap(n)
        if isinstance(n, (AndNode, OrNode)):
            return type(n)([rebuild(c) for c in n.children])
        if isinstance(n, NotNode):
            return NotNode(rebuild(n.child))
        return n

    return rebuild(filter_node)


def megaize_kernels(kernels: Sequence, segment, padded_rows: int,
                    device: torch.device,
                    perm_dig: Optional[str] = None) -> None:
    """`megaize` every filtered aggregator's tree, in place (kernels are
    planned per execution)."""
    from druid_tpu_torch.engine.kernels import FilteredKernel
    for k in kernels:
        while isinstance(k, FilteredKernel):
            k.filter_node = megaize(k.filter_node, segment, padded_rows,
                                    device, perm_dig)
            k = k.child


def record_disabled_fallback(filter_node: Optional[FilterNode],
                             kernels: Sequence = ()) -> None:
    """Stats only: bitmap subtrees, of the query filter and the filtered
    aggregators, that stay staged because the megakernel is off."""
    n = len(item_bitmap_nodes(filter_node, kernels))
    if n:
        _STATS.record_fallback(n)


def mega_leaf_words(segment, dim: str, lut: np.ndarray, padded_rows: int,
                    device: torch.device, perm: Optional[np.ndarray] = None,
                    perm_key=None) -> torch.Tensor:
    """One mega leaf's int32 words [padded_rows / 32]. Where the rows keep
    their order and `dim` has run tables, the bits are built once per run
    (`np.repeat(lut[values], lengths)`) and cached under their own key;
    otherwise they are filters.leaf_words, shared with the staged fill."""
    info = cascade.column_run_info(segment, dim) if perm is None else None
    if info is None:
        return leaf_words(segment, dim, lut, padded_rows, device, perm,
                          perm_key)

    def _build():
        values, ends, _ = info
        bits = np.zeros(padded_rows, dtype=bool)
        bits[: int(ends[-1])] = np.repeat(lut[values],
                                          np.diff(ends, prepend=0))
        return torch.from_numpy(host_words(bits)).to(device)
    return segment.device_cached(
        ("megaleafruns", dim, leaf_digest(lut), padded_rows, str(device)),
        _build)


def stage_mega_leaves(segment, filter_node: Optional[FilterNode],
                      padded_rows: int, device: torch.device,
                      perm: Optional[np.ndarray] = None,
                      perm_key=None, kernels: Sequence = ()
                      ) -> Dict[str, torch.Tensor]:
    """{leaf col: int32 words [padded_rows / 32]} for every mega node's
    leaves, in the query filter and the kernels' filter trees
    (`mega_leaf_words`, cached on the segment); with `perm` the words are
    in the projection's row order."""
    nodes = collect_mega_nodes(filter_node)
    for k in kernels:
        for tree in k.filter_trees():
            nodes.extend(collect_mega_nodes(tree))
    out: Dict[str, torch.Tensor] = {}
    for node in nodes:
        for j, (dim, lut) in enumerate(node.leaves):
            out[node.leaf_col(j)] = mega_leaf_words(
                segment, dim, lut, padded_rows, device, perm, perm_key)
    return out


# ---------------------------------------------------------------------------
# Kernel B2: the sorted-projection reduction with the row mask as words
# ---------------------------------------------------------------------------

def fused_mask_words(arrays: Dict[str, torch.Tensor], mask: torch.Tensor,
                     mega_nodes: Sequence[MegaBitmapNode]) -> torch.Tensor:
    """The base row mask packed to words, ANDed with each mega node's
    combined words (which cover at least as many rows)."""
    words = pack_mask_words(mask)
    for node in mega_nodes:
        words = words & node.words(arrays)[: words.shape[0]]
    return words


def mega_reduce_plain(arrays: Dict[str, torch.Tensor], words: torch.Tensor,
                      key: torch.Tensor, kernels: Sequence, num_total: int,
                      span: int):
    """Plain PyTorch version of B2: the words expanded to bools, then B1's
    plain version. Same inputs, same results."""
    return sorted_reduce_mod.sorted_reduce_plain(
        arrays, expand_mask_words(words, key.shape[0]), key, kernels,
        num_total, span)


def mega_reduce_cuda(arrays: Dict[str, torch.Tensor], words: torch.Tensor,
                     key: torch.Tensor, kernels: Sequence, num_total: int,
                     span: int, packed_cols: Optional[Dict] = None):
    """Launch kernel B2 on CUDA tensors (raw keys, int32 mask words, packed
    value columns as words); raises on anything else."""
    global LAUNCHES
    out = sorted_reduce_mod.launch(arrays, key, kernels, num_total, span,
                                   mask_words=words, packed_cols=packed_cols)
    with COUNT_LOCK:
        LAUNCHES += 1
    return out


def mega_reduce(arrays: Dict[str, torch.Tensor], mask: torch.Tensor,
                key: torch.Tensor, mega_nodes: Sequence[MegaBitmapNode],
                kernels: Sequence, num_total: int, span: int,
                packed_cols: Optional[Dict] = None):
    """(counts int32 [num_total], per-kernel states) over the rows whose
    base mask bit and every mega node's bit are set; `key` is the raw
    compact key (masked rows read as the sentinel inside the kernel). The
    plain version reads the dense view, the kernel `packed_cols` as
    words."""
    global PLAIN_CALLS
    words = fused_mask_words(arrays, mask, mega_nodes)
    if key.device.type == "cpu":
        with COUNT_LOCK:
            PLAIN_CALLS += 1
        return mega_reduce_plain(arrays, words, key, kernels, num_total,
                                 span)
    return mega_reduce_cuda(arrays, words, key, kernels, num_total, span,
                            packed_cols=packed_cols)
