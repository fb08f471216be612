"""Post-aggregators: arithmetic over finalized aggregate values.

The port's copy of the reference package's `query/postaggs.py`:
arithmetic, fieldAccess, finalizingFieldAccess, hyperUniqueCardinality,
constant and the double/long greatest and least, and the extension
registry that `druid_tpu_torch.ext` fills (consulted first, as in the
reference). An unknown type raises ValueError, as in the reference.
Evaluated on the host over result rows, per row (scalars) or per column
(numpy arrays); `to_json` gives the reference's wire form.
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

    def to_json(self) -> dict:
        raise NotImplementedError


@dataclass(frozen=True)
class FieldAccessPostAgg(PostAggregator):
    name: str
    field: str

    def compute(self, row):
        return row.get(self.field)

    def to_json(self):
        return {"type": "fieldAccess", "name": self.name,
                "fieldName": self.field}


@dataclass(frozen=True)
class FinalizingFieldAccessPostAgg(PostAggregator):
    """Aggregators finalize before post-aggregation, so this reads the
    field."""
    name: str
    field: str

    def compute(self, row):
        return row.get(self.field)

    def to_json(self):
        return {"type": "finalizingFieldAccess", "name": self.name,
                "fieldName": self.field}


@dataclass(frozen=True)
class HyperUniqueFinalizingPostAgg(PostAggregator):
    """hyperUniqueCardinality: the HLL aggregator's states are finalized to
    their estimate before post-aggregation, so this reads the field."""
    name: str
    field: str

    def compute(self, row):
        return row.get(self.field)

    def to_json(self):
        return {"type": "hyperUniqueCardinality", "name": self.name,
                "fieldName": self.field}


@dataclass(frozen=True)
class ConstantPostAgg(PostAggregator):
    name: str
    value: float

    def compute(self, row):
        return self.value

    def to_json(self):
        return {"type": "constant", "name": self.name, "value": self.value}


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

    def to_json(self):
        return {"type": "arithmetic", "name": self.name, "fn": self.fn,
                "fields": [f.to_json() for f in self.fields]}


def _extreme(fields, row, pick, pick_arrays):
    """The greatest or least of the fields' values, a null read as 0.0 and
    every value as a float (the reference's rule). Over a row of scalars
    this is the reference's own code; where a field is a column (the
    vectorized finish of groupBy and topN, where the reference raises),
    it is the same rule element by element."""
    vals = [f.compute(row) for f in fields]
    if not any(isinstance(v, np.ndarray) for v in vals):
        return pick(float(v or 0.0) for v in vals)
    cols = [np.asarray(v, dtype=np.float64) if isinstance(v, np.ndarray)
            else np.float64(v or 0.0) for v in vals]
    return pick_arrays.reduce(np.broadcast_arrays(*cols))


@dataclass(frozen=True)
class GreatestPostAgg(PostAggregator):
    name: str
    fields: Tuple[PostAggregator, ...]
    kind: str = "double"

    def compute(self, row):
        return _extreme(self.fields, row, max, np.maximum)

    def to_json(self):
        return {"type": f"{self.kind}Greatest", "name": self.name,
                "fields": [f.to_json() for f in self.fields]}


@dataclass(frozen=True)
class LeastPostAgg(PostAggregator):
    name: str
    fields: Tuple[PostAggregator, ...]
    kind: str = "double"

    def compute(self, row):
        return _extreme(self.fields, row, min, np.minimum)

    def to_json(self):
        return {"type": f"{self.kind}Least", "name": self.name,
                "fields": [f.to_json() for f in self.fields]}


# extension post-aggregator types: type name -> from_json
_EXTENSION_POSTAGGS: dict = {}


def register_postagg(type_name: str, from_json) -> None:
    _EXTENSION_POSTAGGS[type_name] = from_json


def postagg_from_json(j: dict) -> PostAggregator:
    t = j["type"]
    if t in _EXTENSION_POSTAGGS:
        return _EXTENSION_POSTAGGS[t](j)
    # "name" is optional on the nested fields of arithmetic/greatest/least
    if t == "fieldAccess":
        return FieldAccessPostAgg(j.get("name", j["fieldName"]),
                                  j["fieldName"])
    if t == "finalizingFieldAccess":
        return FinalizingFieldAccessPostAgg(j.get("name", j["fieldName"]),
                                            j["fieldName"])
    if t == "hyperUniqueCardinality":
        return HyperUniqueFinalizingPostAgg(j["name"], j["fieldName"])
    if t == "constant":
        return ConstantPostAgg(j.get("name", "const"), j["value"])
    if t == "arithmetic":
        if j["fn"] not in _OPS:
            raise ValueError(f"unknown arithmetic fn {j['fn']!r}")
        return ArithmeticPostAgg(j["name"], j["fn"],
                                 tuple(postagg_from_json(f)
                                       for f in j["fields"]))
    for kind in ("double", "long"):
        if t == f"{kind}Greatest":
            return GreatestPostAgg(j["name"], tuple(
                postagg_from_json(f) for f in j["fields"]), kind)
        if t == f"{kind}Least":
            return LeastPostAgg(j["name"], tuple(
                postagg_from_json(f) for f in j["fields"]), kind)
    raise ValueError(f"unknown post-aggregator type {t!r}")


def compute_postaggs(postaggs, row: Dict[str, object]) -> Dict[str, object]:
    out = dict(row)
    for pa in postaggs:
        out[pa.name] = pa.compute(out)
    return out
