"""Process-wide byte-budgeted pool of device-resident segment data.

The port's counterpart of the reference package's `data/devicepool.py`.
Every device tensor a segment keeps between queries lives here: staged
blocks (`Segment.device_block`), padded derived key columns, filter and
leaf words, run tables (`Segment.device_cached`). The pool evicts the least
recently used entry, by its actual bytes, once the resident bytes pass one
budget (contracts.DEVICE_POOL_BUDGET_SHARE of the card, or
DEVICE_POOL_BUDGET_BYTES without one; `configure` sets it, 0 means
unbounded), so the card's memory under cached data is one number.

An entry is owned by a Segment through an opaque token: when the segment is
garbage-collected, a weakref finalizer marks the token dead and the next
pool operation drops its entries.

What the count means: the pool counts the bytes of the tensors it holds
references to, `numel() * element_size()` per tensor and the words of a
packed column. Evicting an entry drops only the pool's reference: a tensor
that a running query still holds stays on the card until the query lets go
of it, and a tensor cached under two keys counts twice. The pool's count
is of what the pool holds, not of what the card holds.

The mesh's stacked blocks (parallel/distributed.py) live here too, under
the stack owner, with keys that lead with STACKED_KIND: they count against
the same budget and feed the `stacked_*` accounting besides.

`DevicePoolMonitor` emits the pool's metrics. A build runs under a
`pool/h2d` trace span (its bytes as attributes) when a trace is open.

Not ported: `take` (the donated megakernel carries; the port has none).
"""
from __future__ import annotations

import collections
import itertools
import threading
import weakref
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Set, Tuple

import torch

from druid_tpu_torch.obs.trace import span as trace_span
from druid_tpu_torch.utils.emitter import Monitor

#: key[0] of the mesh's stacked blocks (the parallel/distributed.py stack
#: owner's entries): they feed PoolStats.stacked_* besides the budget
STACKED_KIND = "shardStack"


def _default_budget() -> int:
    # lazy: the engine's contracts module is importable once the data
    # modules are
    from druid_tpu_torch.engine.contracts import (DEVICE_POOL_BUDGET_BYTES,
                                                  DEVICE_POOL_BUDGET_SHARE)
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(torch.cuda.current_device())
        return int(DEVICE_POOL_BUDGET_SHARE * props.total_memory)
    return DEVICE_POOL_BUDGET_BYTES


def _fold_entry(value, measure) -> int:
    """The one walker over a pool entry: DeviceBlocks (their `arrays`),
    dicts, tuples and lists are recursed into; every other node is a leaf
    that `measure` sizes. `measure` returns None to recurse, and a leaf it
    cannot size counts 0."""
    if value is None:
        return 0
    got = measure(value)
    if got is not None:
        return int(got)
    arrays = getattr(value, "arrays", None)
    if isinstance(arrays, dict):
        value = arrays
    if isinstance(value, dict):
        return sum(_fold_entry(v, measure) for v in value.values())
    if isinstance(value, (tuple, list)):
        return sum(_fold_entry(v, measure) for v in value)
    return 0


def _measure_nbytes(v):
    if torch.is_tensor(v):
        return v.numel() * v.element_size()
    if isinstance(v, (dict, tuple, list)) or hasattr(v, "arrays"):
        return None
    return getattr(v, "nbytes", None)


def entry_bytes(value) -> int:
    """Device bytes an entry pins: tensors their elements, a packed column
    its words (the compressed bytes), containers their leaves."""
    return _fold_entry(value, _measure_nbytes)


def entry_logical_bytes(value) -> int:
    """The bytes the entry would pin with every column decoded: a packed
    column counts rows x element width, anything else as entry_bytes."""
    def measure(v):
        if torch.is_tensor(v):
            return v.numel() * v.element_size()
        logical = getattr(v, "logical_nbytes", None)
        if logical is not None:
            return logical
        return _measure_nbytes(v)
    return _fold_entry(value, measure)


class LogicalBytes:
    """An accounting-only leaf: `logical_nbytes` decoded bytes and no
    actual bytes. A stack of encoded columns (parallel/distributed.py)
    keeps each column's per-segment descriptor, so its logical_nbytes
    describes one segment while its fields hold K; the stack's entry
    carries one of these for the missing (K - 1) share, so the stacked
    ratio stays true."""

    __slots__ = ("logical_nbytes",)
    nbytes = 0

    def __init__(self, logical_nbytes: int):
        self.logical_nbytes = int(logical_nbytes)


def entry_cascade_bytes(value) -> Tuple[int, int]:
    """(actual, decoded) bytes of the cascade-encoded leaves of an entry
    (data/cascade.py's RLE, delta, FOR and LZ4 columns, marked by
    `cascade_kind`): their ratio is the pool's cascadeRatio."""
    def cascade_leaf(attr):
        def measure(v):
            if getattr(v, "cascade_kind", None) is not None:
                return getattr(v, attr, 0)
            return None if isinstance(v, (dict, tuple, list)) \
                or hasattr(v, "arrays") else 0
        return measure
    return (_fold_entry(value, cascade_leaf("nbytes")),
            _fold_entry(value, cascade_leaf("logical_nbytes")))


@dataclass
class PoolStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    evicted_bytes: int = 0
    resident_bytes: int = 0
    logical_bytes: int = 0
    cascade_bytes: int = 0
    cascade_logical_bytes: int = 0
    stacked_bytes: int = 0
    stacked_logical_bytes: int = 0
    stacked_entries: int = 0
    entries: int = 0
    budget_bytes: int = 0

    @property
    def packed_ratio(self) -> float:
        """Decoded / resident bytes: 1.0 when nothing is packed."""
        return self.logical_bytes / self.resident_bytes \
            if self.resident_bytes else 1.0

    @property
    def cascade_ratio(self) -> float:
        """Decoded / actual bytes over cascade-encoded entries only (1.0
        when none is resident)."""
        return self.cascade_logical_bytes / self.cascade_bytes \
            if self.cascade_bytes else 1.0

    @property
    def stacked_ratio(self) -> float:
        """Decoded / actual bytes over the mesh's stacked blocks only
        (`query/sharded/packedRatio`; 1.0 when nothing is stacked)."""
        return self.stacked_logical_bytes / self.stacked_bytes \
            if self.stacked_bytes else 1.0


class DeviceSegmentPool:
    """Byte-budgeted LRU over (owner, key) -> device value."""

    def __init__(self, budget_bytes: Optional[int] = None):
        self._budget = budget_bytes            # None: resolve lazily
        self._lock = threading.Lock()
        # full key -> (value, bytes, logical bytes, cascade bytes,
        #              cascade logical bytes)
        self._entries: "collections.OrderedDict[Tuple, Tuple]" \
            = collections.OrderedDict()
        self._owner_keys: Dict[int, Set[Tuple]] = {}
        self._owner_seq = itertools.count(1)
        # finalizers only append here (deque.append is atomic): a finalizer
        # can run at any allocation, also while this thread holds the lock,
        # so one that took the lock would deadlock. Dead owners are drained
        # under the lock by the next pool operation.
        self._dead_owners: "collections.deque[int]" = collections.deque()
        # full key -> Event of the build in flight: a second caller of the
        # same key waits for it instead of staging the same bytes again
        self._inflight: Dict[Tuple, threading.Event] = {}
        self._resident = 0
        self._logical = 0
        self._cascade = 0
        self._cascade_logical = 0
        self._stacked = 0
        self._stacked_logical = 0
        self._stacked_entries = 0
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._evicted_bytes = 0

    # ---- configuration --------------------------------------------------
    @property
    def budget_bytes(self) -> int:
        """The resolved budget; <= 0 means unbounded."""
        if self._budget is None:
            self._budget = _default_budget()
        return self._budget

    def configure(self, budget_bytes: Optional[int]) -> None:
        """Set the byte budget (None: the default again; <= 0: unbounded)
        and evict down to it now."""
        with self._lock:
            self._drain_dead_locked()
            self._budget = budget_bytes
            budget = self.budget_bytes
            if budget > 0:
                self._evict_to(budget, keep=None)

    # ---- owners ---------------------------------------------------------
    def register_owner(self, obj) -> int:
        """An opaque token for `obj`'s entries. A weakref finalizer marks it
        dead when `obj` is collected; the token's presence in the registry
        is the liveness bit `get_or_build` checks before caching."""
        with self._lock:
            self._drain_dead_locked()
            token = next(self._owner_seq)
            self._owner_keys[token] = set()
        weakref.finalize(obj, self._note_dead, token)
        return token

    def _note_dead(self, owner: int) -> None:
        """The finalizer. It never takes the lock (see __init__)."""
        self._dead_owners.append(owner)

    def _drain_dead_locked(self) -> int:
        """Caller holds the lock: purge every owner a finalizer reported."""
        freed = 0
        while True:
            try:
                owner = self._dead_owners.popleft()
            except IndexError:
                break
            freed += self._purge_locked(owner)
        return freed

    @staticmethod
    def _is_stacked(full_key: Tuple) -> bool:
        # full_key = (owner,) + key; stacked blocks lead with STACKED_KIND
        return len(full_key) > 1 and full_key[1] == STACKED_KIND

    def _count_locked(self, full_key: Tuple, entry: Tuple, sign: int) -> None:
        """Caller holds the lock: add (sign 1) or take away (sign -1) an
        entry's bytes. Every insert and every removal (purge, evict,
        replace) goes through here, so the counters cannot drift."""
        self._resident += sign * entry[1]
        self._logical += sign * entry[2]
        self._cascade += sign * entry[3]
        self._cascade_logical += sign * entry[4]
        if self._is_stacked(full_key):
            self._stacked += sign * entry[1]
            self._stacked_logical += sign * entry[2]
            self._stacked_entries += sign

    def _purge_locked(self, owner: int) -> int:
        freed = 0
        for key in self._owner_keys.pop(owner, ()):
            entry = self._entries.pop(key, None)
            if entry is not None:
                freed += entry[1]
                self._count_locked(key, entry, -1)
        return freed

    def purge_owner(self, owner: int) -> int:
        """Drop every entry of `owner` now and mark it dead (an in-flight
        build cannot bring its entries back); returns the bytes released.
        A purge is not an eviction."""
        with self._lock:
            return self._purge_locked(owner)

    def owner_entries(self, owner: int) -> Dict[Tuple, object]:
        """{key: value} of `owner`'s resident entries, without touching the
        LRU order or the counters."""
        with self._lock:
            self._drain_dead_locked()
            return {k[1:]: self._entries[k][0]
                    for k in self._owner_keys.get(owner, ())
                    if k in self._entries}

    # ---- the cache ------------------------------------------------------
    def peek(self, owner: int, key: Tuple) -> bool:
        """Residency probe that touches neither the LRU order nor the
        counters (the filter-word cache keeps its own hit counts)."""
        with self._lock:
            return ((owner,) + tuple(key)) in self._entries

    def get_or_build(self, owner: int, key: Tuple,
                     build: Callable[[], object]):
        """LRU get; on a miss `build()` runs outside the lock (it stages to
        the card), and its value is cached unless the owner died meanwhile.
        One build per key at a time: a concurrent caller of a key being
        built (two broker threads on one cold segment) waits for it and
        then reads the entry as a hit. A build only ever waits on the keys
        it itself reads, so the waits cannot form a cycle."""
        full_key = (owner,) + tuple(key)
        while True:
            with self._lock:
                self._drain_dead_locked()
                hit = self._entries.get(full_key)
                if hit is not None:
                    self._entries.move_to_end(full_key)
                    self._hits += 1
                    return hit[0]
                pending = self._inflight.get(full_key)
                if pending is None:
                    self._misses += 1
                    done = self._inflight[full_key] = threading.Event()
                    break
            pending.wait()
        try:
            # a cold miss: the staging cost a warm pool hides
            with trace_span("pool/h2d",
                            kind=str(key[0]) if key else "") as sp:
                value = build()
                entry = (value, entry_bytes(value),
                         entry_logical_bytes(value)) \
                    + entry_cascade_bytes(value)
                if sp is not None:
                    sp.attrs["bytes"] = entry[1]
                    sp.attrs["logicalBytes"] = entry[2]
        except BaseException:
            with self._lock:
                self._inflight.pop(full_key, None)
            done.set()
            raise
        with self._lock:
            self._inflight.pop(full_key, None)
            done.set()
            self._drain_dead_locked()
            keys = self._owner_keys.get(owner)
            if keys is None:
                # the owner was collected while build() ran: hand the value
                # back uncached (no finalizer would ever drop it)
                return value
            old = self._entries.pop(full_key, None)
            if old is not None:
                self._count_locked(full_key, old, -1)
            self._entries[full_key] = entry
            keys.add(full_key)
            self._count_locked(full_key, entry, 1)
            budget = self.budget_bytes
            if budget > 0:
                self._evict_to(budget, keep=full_key)
        return value

    def _evict_to(self, budget: int, keep: Optional[Tuple]) -> None:
        """Caller holds the lock. Evict least recently used entries until
        the resident bytes fit `budget`; `keep` (the entry just built, which
        the running query reads) survives even when it alone is over."""
        while self._resident > budget and self._entries:
            key = next(iter(self._entries))
            if key == keep:
                if len(self._entries) == 1:
                    return
                self._entries.move_to_end(key)
                continue
            entry = self._entries.pop(key)
            self._owner_keys.get(key[0], set()).discard(key)
            self._count_locked(key, entry, -1)
            self._evictions += 1
            self._evicted_bytes += entry[1]

    def clear(self) -> None:
        """Drop every entry; live owners stay registered (clearing their
        slots would refuse their inserts for good)."""
        with self._lock:
            self._entries.clear()
            for keys in self._owner_keys.values():
                keys.clear()
            self._resident = self._logical = 0
            self._cascade = self._cascade_logical = 0
            self._stacked = self._stacked_logical = 0
            self._stacked_entries = 0

    # ---- observability --------------------------------------------------
    def snapshot(self) -> PoolStats:
        with self._lock:
            self._drain_dead_locked()
            return PoolStats(hits=self._hits, misses=self._misses,
                             evictions=self._evictions,
                             evicted_bytes=self._evicted_bytes,
                             resident_bytes=self._resident,
                             logical_bytes=self._logical,
                             cascade_bytes=self._cascade,
                             cascade_logical_bytes=self._cascade_logical,
                             stacked_bytes=self._stacked,
                             stacked_logical_bytes=self._stacked_logical,
                             stacked_entries=self._stacked_entries,
                             entries=len(self._entries),
                             budget_bytes=self.budget_bytes)


_POOL = DeviceSegmentPool()


def device_pool() -> DeviceSegmentPool:
    """The process-wide pool every Segment stages through."""
    return _POOL


class DevicePoolMonitor(Monitor):
    """Emits `segment/devicePool/*` metrics per tick: the hit RATE over the
    tick window (only when there was traffic — an idle pool emits no rate),
    delta hit/miss/evicted counters, and resident gauges."""

    def __init__(self, pool: Optional[DeviceSegmentPool] = None):
        self.pool = pool or device_pool()
        self._last = PoolStats()

    def do_monitor(self, emitter):
        s = self.pool.snapshot()
        last, self._last = self._last, s
        d_hits = s.hits - last.hits
        d_misses = s.misses - last.misses
        if d_hits + d_misses > 0:
            emitter.metric("segment/devicePool/hitRate",
                           d_hits / (d_hits + d_misses))
        emitter.metric("segment/devicePool/hits", d_hits)
        emitter.metric("segment/devicePool/misses", d_misses)
        emitter.metric("segment/devicePool/evictedBytes",
                       s.evicted_bytes - last.evicted_bytes)
        emitter.metric("segment/devicePool/residentBytes", s.resident_bytes)
        emitter.metric("segment/devicePool/entries", s.entries)
        emitter.metric("segment/devicePool/packedRatio", s.packed_ratio)
        emitter.metric("segment/devicePool/cascadeRatio", s.cascade_ratio)
