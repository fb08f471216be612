"""Post-aggregators: arithmetic over finalized aggregate values.

The port's copy of the reference package's `query/postaggs.py`, cut to
arithmetic, fieldAccess, finalizingFieldAccess, hyperUniqueCardinality and
constant. Any other type
raises NotImplementedError. Evaluated on the host over result rows, per row
(scalars) or per column (numpy arrays).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


class PostAggregator:
    name: str

    def compute(self, row: Dict[str, object]) -> object:
        raise NotImplementedError


@dataclass(frozen=True)
class FieldAccessPostAgg(PostAggregator):
    name: str
    field: str

    def compute(self, row):
        return row.get(self.field)


@dataclass(frozen=True)
class HyperUniqueFinalizingPostAgg(PostAggregator):
    """hyperUniqueCardinality: the HLL aggregator's states are finalized to
    their estimate before post-aggregation, so this reads the field."""
    name: str
    field: str

    def compute(self, row):
        return row.get(self.field)


@dataclass(frozen=True)
class ConstantPostAgg(PostAggregator):
    name: str
    value: float

    def compute(self, row):
        return self.value


def _safe_div(a, b, zero):
    """Array-safe division (reference: division by zero -> 0)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        b_arr = np.asarray(b, dtype=np.float64)
        return np.where(b_arr != 0, np.asarray(a, dtype=np.float64)
                        / np.where(b_arr != 0, b_arr, 1.0), zero)
    return (a / b) if b else zero


_OPS = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: _safe_div(a, b, 0.0),
    "quotient": lambda a, b: _safe_div(a, b, math.nan),
}


@dataclass(frozen=True)
class ArithmeticPostAgg(PostAggregator):
    name: str
    fn: str
    fields: Tuple[PostAggregator, ...]

    def compute(self, row):
        op = _OPS[self.fn]
        vals = [f.compute(row) for f in self.fields]
        vals = [0.0 if v is None else v for v in vals]
        vals = [v if isinstance(v, np.ndarray) else float(v) for v in vals]
        out = vals[0]
        for v in vals[1:]:
            out = op(out, v)
        return out


def postagg_from_json(j: dict) -> PostAggregator:
    t = j["type"]
    if t in ("fieldAccess", "finalizingFieldAccess"):
        return FieldAccessPostAgg(j.get("name", j["fieldName"]), j["fieldName"])
    if t == "hyperUniqueCardinality":
        return HyperUniqueFinalizingPostAgg(j["name"], j["fieldName"])
    if t == "constant":
        return ConstantPostAgg(j.get("name", "const"), j["value"])
    if t == "arithmetic":
        if j["fn"] not in _OPS:
            raise NotImplementedError(f"arithmetic fn {j['fn']!r}")
        return ArithmeticPostAgg(j["name"], j["fn"],
                                 tuple(postagg_from_json(f) for f in j["fields"]))
    raise NotImplementedError(f"post-aggregator type {t!r}")


def compute_postaggs(postaggs, row: Dict[str, object]) -> Dict[str, object]:
    out = dict(row)
    for pa in postaggs:
        out[pa.name] = pa.compute(out)
    return out
