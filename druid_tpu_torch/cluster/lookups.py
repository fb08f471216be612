"""Cluster-wide lookup management: coordinator-owned specs, node sync.

The port's copy of the reference package's `cluster/lookups.py`: host
code over the port's modules.

Reference analog: server/src/main/java/org/apache/druid/server/lookup/cache/
LookupCoordinatorManager.java — lookup definitions live in the metadata
store keyed by TIER; the coordinator pushes them to every node in that
tier; nodes apply version-gated updates into their process-local
LookupReferencesManager (query/lookup.py). A node that (re)starts syncs to
the current spec set on its next poll — the same convergence contract as
the reference's periodic lookup management loop.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from druid_tpu_torch.cluster.metadata import MetadataStore
from druid_tpu_torch.query.lookup import LookupReferencesManager
from druid_tpu_torch.utils.intervals import parse_period_ms

_CONFIG_KEY = "lookups"

#: extractionNamespace type → loader(namespace_spec) -> Dict[str, str]
#: (the lookups-cached-global extension registers "uri" here)
_NAMESPACE_LOADERS: Dict[str, object] = {}


def register_namespace_loader(type_name: str, loader) -> None:
    _NAMESPACE_LOADERS[type_name] = loader


def _period_seconds(val) -> float:
    """pollPeriod as seconds: numbers pass through, ISO-8601 periods
    ("PT5M") parse like the reference's Period configs; anything
    malformed disables periodic refresh for THAT lookup instead of
    crashing the whole poll."""
    if val is None:
        return 0.0
    try:
        return float(val)
    except (TypeError, ValueError):
        pass
    try:
        return parse_period_ms(str(val)) / 1000.0
    except (TypeError, ValueError):
        return 0.0


class LookupCoordinatorManager:
    """Authoritative lookup spec store + push loop."""

    def __init__(self, metadata: MetadataStore):
        self.metadata = metadata
        self._lock = threading.Lock()

    # ---- spec CRUD (POST /druid/coordinator/v1/lookups analog) ---------
    def _load(self) -> Dict[str, Dict[str, dict]]:
        return self.metadata.get_config(_CONFIG_KEY, {}) or {}

    def _store(self, specs: Dict[str, Dict[str, dict]]) -> None:
        self.metadata.set_config(_CONFIG_KEY, specs)

    def _next_version(self, tier_specs: Dict[str, dict], name: str,
                      version: Optional[str]) -> str:
        if version is not None:
            return version
        cur = tier_specs.get(name, {}).get("version")
        return f"v{int(cur[1:]) + 1}" \
            if cur and cur[0] == "v" and cur[1:].isdigit() else \
            (f"v{int(time.time() * 1000)}" if cur else "v0")

    def set_lookup(self, tier: str, name: str, mapping: Dict[str, str],
                   version: Optional[str] = None) -> str:
        """Create/update one lookup; bumps the version unless given."""
        with self._lock:
            specs = self._load()
            tier_specs = specs.setdefault(tier, {})
            version = self._next_version(tier_specs, name, version)
            tier_specs[name] = {"version": version,
                                "lookupExtractorFactory": {
                                    "type": "map", "map": dict(mapping)}}
            self._store(specs)
            return version

    def set_namespace_lookup(self, tier: str, name: str, namespace: dict,
                             version: Optional[str] = None) -> str:
        """Register a namespace-backed lookup (reference: the
        lookups-cached-global cachedNamespace factory): nodes materialize
        the map by running the namespace's registered loader and re-poll it
        every `pollPeriod` seconds."""
        with self._lock:
            specs = self._load()
            tier_specs = specs.setdefault(tier, {})
            version = self._next_version(tier_specs, name, version)
            tier_specs[name] = {"version": version,
                                "lookupExtractorFactory": {
                                    "type": "cachedNamespace",
                                    "extractionNamespace": dict(namespace)}}
            self._store(specs)
            return version

    def delete_lookup(self, tier: str, name: str) -> bool:
        with self._lock:
            specs = self._load()
            if name not in specs.get(tier, {}):
                return False
            del specs[tier][name]
            self._store(specs)
            return True

    def get_tier(self, tier: str) -> Dict[str, dict]:
        return dict(self._load().get(tier, {}))

    def tiers(self) -> List[str]:
        return sorted(self._load())


class LookupNodeSync:
    """Node-side sync: pull the tier's specs and apply version-gated
    updates into the local registry (LookupReferencesManager start-and-
    listen behavior). Call poll() from the node's periodic loop."""

    def __init__(self, manager: LookupCoordinatorManager, tier: str,
                 registry: LookupReferencesManager):
        self.manager = manager
        self.tier = tier
        self.registry = registry
        self._owner = f"lookup-sync:{tier}"
        self._ns_loaded: Dict[str, float] = {}   # name → last load ts

    def poll(self) -> int:
        """Apply current specs; returns how many lookups changed.

        Authority follows the registry's explicit `owner` field: this sync
        only ever replaces or deletes entries it owns. Process-local
        register_lookup() entries (owner None) and other tiers' entries
        are untouchable — a name collision means the first writer wins
        and the spec is skipped."""
        import re
        specs = self.manager.get_tier(self.tier)
        changed = 0
        for name, spec in specs.items():
            factory = spec.get("lookupExtractorFactory", {})
            version = spec.get("version", "v0")
            cur = self.registry.get(name)
            if cur is not None and cur.owner != self._owner:
                continue          # not ours: never overwrite, never load
            if factory.get("type") == "map":
                if cur is not None and re.search(r"\+\d{9}$", cur.version):
                    # converting a namespace lookup (reload-STAMP version,
                    # ours by the owner check) back to a plain map: even an
                    # identical spec version would be outranked by its own
                    # longer stamp — swap atomically, no unregistered gap
                    if self.registry.force_replace(
                            name, factory.get("map", {}), version,
                            self._owner):
                        self._ns_loaded.pop(name, None)
                        changed += 1
                elif self.registry.add(name, factory.get("map", {}),
                                       version=version, owner=self._owner):
                    changed += 1
            elif factory.get("type") == "cachedNamespace":
                if self._poll_namespace(name, factory, version, cur):
                    changed += 1
        for name in self.registry.names():
            if name in specs:
                continue
            cur = self.registry.get(name)
            if cur is not None and cur.owner == self._owner:
                self.registry.remove(name)
                self._ns_loaded.pop(name, None)
                changed += 1
        return changed

    def _poll_namespace(self, name: str, factory: dict, version: str,
                        cur) -> bool:
        """(Re)load a namespace-backed lookup when the spec version moved
        or pollPeriod elapsed. A failed load KEEPS the last good mapping
        (the reference's cached-namespace behavior). `cur` is this sync's
        own entry or None (foreign entries were filtered by the caller)."""
        ns = factory.get("extractionNamespace", {})
        loader = _NAMESPACE_LOADERS.get(str(ns.get("type")))
        if loader is None:
            return False          # extension not loaded on this node
        import re
        period = _period_seconds(ns.get("pollPeriod"))
        now = time.time()
        last = self._ns_loaded.get(name)
        stamp = None if cur is None else re.match(
            rf"^{re.escape(version)}\+(\d{{9}})$", cur.version)
        spec_changed = stamp is None
        # `last is None` counts as due: a recreated sync over a registry
        # that already holds the lookup must still honor pollPeriod
        due = spec_changed or (period > 0
                               and (last is None or now - last >= period))
        if not due:
            return False
        try:
            mapping = loader(ns)
        except Exception:
            # keep serving the last good mapping
            logging.getLogger(__name__).warning(
                "namespace load for lookup [%s] failed; keeping previous "
                "mapping", name, exc_info=True)
            return False
        self._ns_loaded[name] = now
        if not spec_changed and cur is not None \
                and mapping == cur.mapping:
            return False          # unchanged content: no registry churn
        if spec_changed and cur is not None:
            # our entry under an older spec version: swap atomically (the
            # old stamp could outrank the new version string, and a
            # remove+add gap would briefly 404 concurrent get_lookup())
            return self.registry.force_replace(
                name, mapping, f"{version}+{0:09d}", self._owner)
        # stamped reload counter keeps periodic refreshes version-ascending
        n = 0 if spec_changed else int(stamp.group(1)) + 1
        return self.registry.add(name, mapping,
                                 version=f"{version}+{n:09d}",
                                 owner=self._owner)
