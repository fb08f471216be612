"""Sorted string dictionary for dictionary-encoded dimension columns.

Capability parity with the reference's GenericIndexed<String> dictionary
(processing/src/main/java/org/apache/druid/segment/data/GenericIndexed.java:79
— sorted value index). The dictionary lives host-side only; the device only
ever sees int32 id columns. The string predicates (selector/bound/in) are
evaluated host-side against the (small) dictionary to produce a boolean
lookup table that the device applies via one gather — see engine/filters.py.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np

#: null and "" are one value (Druid's pre-0.13 null handling, as the
#: reference)
NULL = ""


class Dictionary:
    """Immutable sorted list of unique strings."""

    __slots__ = ("values", "_index")

    def __init__(self, sorted_values: Sequence[str]):
        self.values: List[str] = list(sorted_values)
        self._index = {v: i for i, v in enumerate(self.values)}

    @staticmethod
    def from_values(values: Iterable[Optional[str]]) -> "Dictionary":
        return Dictionary(sorted({NULL if v is None else str(v)
                                  for v in values}))

    @property
    def cardinality(self) -> int:
        return len(self.values)

    def id_of(self, value: Optional[str]) -> int:
        """id of value (None reads as ""), or -1 if absent."""
        return self._index.get("" if value is None else value, -1)

    def encode(self, values: Iterable[Optional[str]]) -> np.ndarray:
        """int32 ids of `values` (each must be in the dictionary)."""
        idx = self._index
        return np.fromiter((idx[NULL if v is None else str(v)]
                            for v in values), dtype=np.int32)

    def __len__(self):
        return len(self.values)

    def __iter__(self):
        return iter(self.values)

    def __contains__(self, v):
        return v in self._index

    def __eq__(self, other):
        return isinstance(other, Dictionary) and self.values == other.values

    def __hash__(self):
        return hash(tuple(self.values))


def merge_dictionaries(dicts: Sequence[Dictionary]):
    """Merge dictionaries into one sorted dictionary plus per-input id remap
    tables (old id -> new id, int32), the role the reference's
    DimensionMergerV9 plays."""
    merged = sorted(set().union(*[set(d.values) for d in dicts])) \
        if dicts else []
    out = Dictionary(merged)
    remaps = [np.asarray([out.id_of(v) for v in d.values], dtype=np.int32)
              for d in dicts]
    return out, remaps
