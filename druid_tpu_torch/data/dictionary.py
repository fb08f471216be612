"""Sorted string dictionary for dictionary-encoded dimension columns.

Capability parity with the reference's GenericIndexed<String> dictionary
(processing/src/main/java/org/apache/druid/segment/data/GenericIndexed.java:79
— sorted value index). The dictionary lives host-side only; the device only
ever sees int32 id columns. The string predicates (selector/bound/in) are
evaluated host-side against the (small) dictionary to produce a boolean
lookup table that the device applies via one gather — see engine/filters.py.
"""
from __future__ import annotations

from typing import List, Sequence


class Dictionary:
    """Immutable sorted list of unique strings."""

    __slots__ = ("values", "_index")

    def __init__(self, sorted_values: Sequence[str]):
        self.values: List[str] = list(sorted_values)
        self._index = {v: i for i, v in enumerate(self.values)}

    @property
    def cardinality(self) -> int:
        return len(self.values)

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
