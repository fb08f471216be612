"""Process-wide named lookup registry.

The port's copy of the reference package's `query/lookup.py` (the
reference's LookupReferencesManager: a registry of named key→value maps,
versioned), cut to what `RegisteredLookupExtractionFn` (query/model.py)
reads: register, get and remove. The cluster's lookup sync (owners,
unconditional replace, snapshots) comes with serving (ROADMAP A11).
Lookups are applied on the host over dictionaries (O(cardinality)), never
on the device.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional


@dataclass
class LookupContainer:
    """A named lookup version (reference: LookupExtractorFactoryContainer)."""
    name: str
    mapping: Dict[str, str]
    version: str = "v0"


class LookupReferencesManager:
    """Thread-safe registry of named lookups with versioned replace."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lookups: Dict[str, LookupContainer] = {}

    @staticmethod
    def _version_key(v: str):
        # length-then-lexicographic: numeric suffixes compare naturally
        # ("v9" < "v10"), equal-length versions compare lexicographically
        return (len(v), v)

    def add(self, name: str, mapping: Dict[str, str],
            version: str = "v0") -> bool:
        """Register or replace; a replace with a version <= the current one
        is a no-op (the reference's version-gated update)."""
        with self._lock:
            cur = self._lookups.get(name)
            if cur is not None and \
                    self._version_key(version) <= self._version_key(cur.version):
                return False
            self._lookups[name] = LookupContainer(name, dict(mapping),
                                                  version)
            return True

    def remove(self, name: str) -> bool:
        with self._lock:
            return self._lookups.pop(name, None) is not None

    def get(self, name: str) -> Optional[LookupContainer]:
        with self._lock:
            return self._lookups.get(name)


_MANAGER = LookupReferencesManager()


def lookup_manager() -> LookupReferencesManager:
    return _MANAGER


def register_lookup(name: str, mapping: Dict[str, str],
                    version: str = "v0") -> bool:
    return _MANAGER.add(name, mapping, version)


def get_lookup(name: str) -> Dict[str, str]:
    c = _MANAGER.get(name)
    if c is None:
        raise KeyError(f"lookup [{name}] not registered")
    return c.mapping
