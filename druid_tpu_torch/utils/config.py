"""Layered configuration (the port's copy of the reference package's
`utils/config.py`).

Reference analog: runtime.properties per node → Guice JsonConfigProvider /
JsonConfigurator binding `druid.*` property subtrees onto validated config
objects (api/.../guice/JsonConfigProvider.java), `PolyBind` selecting
implementations by property value, and per-query `query.context` overrides.

Layers (later wins): defaults → config file (.json or .properties) →
an environment layer (DRUID_TPU_x_y for property x.y) → programmatic
overrides.

The one divergence from the reference: the environment layer is only what
the caller passes as `env=`. With env=None the reference reads os.environ;
the port reads no environment at all (the CLI passes none), so a node's
configuration is its file and its command line.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional


class Config:
    """Property keys are case-insensitive (stored lowercased) so the
    env layer — where names arrive upper-snake — composes with camelCase
    file/code keys."""

    def __init__(self, properties: Optional[Dict[str, object]] = None):
        self._props: Dict[str, object] = {
            k.lower(): v for k, v in (properties or {}).items()}

    # ---- layering ------------------------------------------------------
    @staticmethod
    def load(path: Optional[str] = None,
             env: Optional[Dict[str, str]] = None,
             overrides: Optional[Dict[str, object]] = None,
             env_prefix: str = "DRUID_TPU_") -> "Config":
        props: Dict[str, object] = {}
        if path and os.path.exists(path):
            if path.endswith(".json"):
                with open(path) as f:
                    props.update(_flatten(json.load(f)))
            else:
                with open(path) as f:
                    for line in f:
                        line = line.strip()
                        if not line or line.startswith(("#", "!")):
                            continue
                        if "=" in line:
                            k, v = line.split("=", 1)
                            props[k.strip()] = v.strip()
        for k, v in (env or {}).items():
            if k.startswith(env_prefix):
                prop = k[len(env_prefix):].lower().replace("_", ".")
                props[prop] = v
        props.update(overrides or {})
        return Config(props)

    def with_overrides(self, overrides: Dict[str, object]) -> "Config":
        out = dict(self._props)
        out.update({k.lower(): v for k, v in overrides.items()})
        return Config(out)

    # ---- typed access --------------------------------------------------
    def get(self, key: str, default=None):
        return self._props.get(key.lower(), default)

    def get_int(self, key: str, default: int = 0) -> int:
        v = self._props.get(key.lower())
        return default if v is None else int(v)

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self._props.get(key.lower())
        return default if v is None else float(v)

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self._props.get(key.lower())
        if v is None:
            return default
        if isinstance(v, bool):
            return v
        return str(v).lower() in ("true", "1", "yes")

    def subtree(self, prefix: str) -> Dict[str, object]:
        """All `prefix.x` properties as {x: value} (JsonConfigProvider's
        subtree binding)."""
        p = prefix.lower().rstrip(".") + "."
        return {k[len(p):]: v for k, v in self._props.items()
                if k.startswith(p)}

    def select(self, key: str, registry: Dict[str, Callable], default: str,
               **kw):
        """PolyBind: instantiate the implementation named by a property."""
        kind = str(self._props.get(key.lower(), default))
        if kind not in registry:
            raise ValueError(
                f"unknown {key}={kind!r}; options: {sorted(registry)}")
        return registry[kind](**kw)

    def to_dict(self) -> Dict[str, object]:
        return dict(self._props)


def _flatten(tree: dict, prefix: str = "") -> Dict[str, object]:
    out: Dict[str, object] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}" if not prefix else f"{prefix}.{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out
