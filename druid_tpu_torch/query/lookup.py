"""Process-wide named lookup registry.

The port's copy of the reference package's `query/lookup.py`. Reference
analog: query/lookup/LookupExtractorFactoryContainerProvider +
LookupReferencesManager (server-side registry of named key→value maps,
versioned, distributed by the coordinator — server/lookup/cache/
LookupCoordinatorManager.java). Here: an in-process versioned registry;
`cluster/lookups.py` distributes lookup definitions to nodes the way the
coordinator pushes them over HTTP, and owns the entries it writes.

Lookups are applied on the host over dictionaries (O(cardinality)), never
on the device — see ExtractionFn in query/model.py.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class LookupContainer:
    """A named lookup version (reference: LookupExtractorFactoryContainer).
    `owner` records which manager wrote it (None = process-local
    register_lookup; "lookup-sync:<tier>" = cluster sync) — deletion and
    replacement authority follow ownership, never version-string shape."""
    name: str
    mapping: Dict[str, str]
    version: str = "v0"
    owner: object = None


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
            version: str = "v0", owner: object = None) -> bool:
        """Register/replace; a replace with a version <= current is a no-op
        (mirrors LookupReferencesManager version-gated updates). A write
        from a DIFFERENT owner than the current entry's never applies —
        first writer wins on a name collision; the other party must
        remove() first (which only the owning sync does)."""
        with self._lock:
            cur = self._lookups.get(name)
            if cur is not None and cur.owner != owner:
                return False
            if cur is not None and \
                    self._version_key(version) <= self._version_key(cur.version):
                return False
            # version-gated replace registry: later versions overwrite
            # by design — the name is the identity, not a build key
            self._lookups[name] = LookupContainer(name, dict(mapping),
                                                  version, owner)
            return True

    def force_replace(self, name: str, mapping: Dict[str, str],
                      version: str = "v0", owner: object = None) -> bool:
        """Atomic ownership-checked replace with NO version gate — the
        owning sync swapping its own entry across version-scheme changes
        (namespace stamp → plain spec version). One lock acquisition, so
        concurrent get_lookup() never observes the name missing."""
        with self._lock:
            cur = self._lookups.get(name)
            if cur is not None and cur.owner != owner:
                return False
            # ownership-checked replace registry (see add() above)
            self._lookups[name] = LookupContainer(name, dict(mapping),
                                                  version, owner)
            return True

    def remove(self, name: str) -> bool:
        with self._lock:
            return self._lookups.pop(name, None) is not None

    def get(self, name: str) -> Optional[LookupContainer]:
        with self._lock:
            return self._lookups.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._lookups)

    def snapshot(self) -> List[dict]:
        """Introspection/persistence snapshot (LookupSnapshotTaker analog)."""
        with self._lock:
            return [{"name": c.name, "version": c.version, "map": dict(c.mapping)}
                    for c in self._lookups.values()]


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
