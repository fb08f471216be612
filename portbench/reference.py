"""The plain reference: Druid's semantics for the queries of the mixes,
in plain PyTorch over the columns the generators make.

It imports nothing of the port. It regenerates each segment's columns
from the seed (`gen/<generator>.py`), evaluates the filters, virtual
columns, buckets and aggregators of every query directly, and sums into
one dense table a query, on the device it is given. With
`precision="exact"` LONG sums and counts accumulate in int64 and DOUBLE
sums in float64; with `precision="float32"` every sum accumulates in
float32 (the control: the step below what the configurations state).

Answers are normalized to {(bucket ms, dim values...): {name: value}}
with `normalize`, which reads a reply of the port the same way, and
`compare` holds a reply against the reference's answer.
"""
from __future__ import annotations

import datetime as _dt
import importlib
import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from portbench.gen import common

DENSE_LIMIT = 64_000_000          # cells of one query's table


def generator_module(cfg: dict):
    return importlib.import_module(f"portbench.gen.{cfg['generator']}")


# ---------------------------------------------------------------------------
# Times and buckets
# ---------------------------------------------------------------------------

def parse_ms(text: str) -> int:
    """ISO date or date-time (UTC) -> epoch ms."""
    text = text.strip().rstrip("Z")
    if "T" not in text:
        d = _dt.date.fromisoformat(text)
        return (d - _dt.date(1970, 1, 1)).days * common.DAY_MS
    t = _dt.datetime.fromisoformat(text).replace(tzinfo=_dt.timezone.utc)
    return int(round(t.timestamp() * 1000))


def intervals_ms(query: dict) -> List[Tuple[int, int]]:
    out = []
    for iv in query["intervals"]:
        a, b = iv.split("/")
        out.append((parse_ms(a), parse_ms(b)))
    return sorted(out)


_STARTS = {"year": common.year_starts(), "month": common.month_starts()}


def granularity_of(query: dict) -> str:
    g = query.get("granularity", "all")
    if isinstance(g, dict):
        g = g.get("type", "all")
    g = g.lower()
    if g not in ("all", "year", "month", "day"):
        raise NotImplementedError(f"granularity {g!r}")
    return g


def bucket_days(gran: str, day: torch.Tensor) -> torch.Tensor:
    """Each row's bucket start (days) for a granularity other than all."""
    if gran == "day":
        return day
    starts = torch.tensor(_STARTS[gran], device=day.device,
                          dtype=torch.int64)
    return starts[torch.searchsorted(starts, day, right=True) - 1]


def bucket_list(gran: str, ivs: Sequence[Tuple[int, int]],
                first_day: int, last_day: int) -> List[int]:
    """Bucket starts (days) that can hold rows of the intervals."""
    lo = max(first_day, min(-(-a // common.DAY_MS) for a, _ in ivs))
    hi = min(last_day, max(-(-b // common.DAY_MS) - 1 for _, b in ivs))
    if gran == "day":
        return list(range(lo, hi + 1))
    starts = _STARTS[gran]
    return [s for i, s in enumerate(starts)
            if s <= hi and (i + 1 == len(starts) or starts[i + 1] > lo)]


# ---------------------------------------------------------------------------
# Filters and expressions
# ---------------------------------------------------------------------------

def _like_regex(pattern: str) -> re.Pattern:
    out = []
    for ch in pattern:
        out.append(".*" if ch == "%" else "." if ch == "_"
                   else re.escape(ch))
    return re.compile("".join(out), re.DOTALL)


def _value_test(f: dict):
    """A test of one dimension value (a string) for the leaf filter f."""
    t = f["type"]
    if t == "selector":
        return lambda x: x == f.get("value")
    if t == "in":
        vs = set(f["values"])
        return lambda x: x in vs
    if t == "like":
        rx = _like_regex(f["pattern"])
        return lambda x: rx.fullmatch(x) is not None
    if t == "bound":
        conv = float if f.get("ordering") == "numeric" else str
        lo, hi = f.get("lower"), f.get("upper")

        def test(x):
            x = conv(x)
            if lo is not None and (x < conv(lo) or (
                    f.get("lowerStrict") and x == conv(lo))):
                return False
            if hi is not None and (x > conv(hi) or (
                    f.get("upperStrict") and x == conv(hi))):
                return False
            return True
        return test
    raise NotImplementedError(f"filter {t!r}")


def _numeric_mask(f: dict, col: torch.Tensor) -> torch.Tensor:
    """A leaf filter over a numeric column, compared as numbers."""
    t = f["type"]
    x = col.to(torch.float64)
    if t == "selector":
        return x == float(f["value"])
    if t == "in":
        return torch.isin(x, torch.tensor([float(v) for v in f["values"]],
                                          device=x.device,
                                          dtype=torch.float64))
    if t == "bound" and f.get("ordering") == "numeric":
        m = torch.ones_like(x, dtype=torch.bool)
        if f.get("lower") is not None:
            lo = float(f["lower"])
            m &= (x > lo) if f.get("lowerStrict") else (x >= lo)
        if f.get("upper") is not None:
            hi = float(f["upper"])
            m &= (x < hi) if f.get("upperStrict") else (x <= hi)
        return m
    raise NotImplementedError(f"filter {t!r} on a numeric column")


@dataclass
class Rows:
    """One segment's columns as the reference reads them."""
    cols: common.Columns
    values: Dict[str, List[str]]
    virtual: Dict[str, torch.Tensor] = field(default_factory=dict)

    def dim(self, name: str):
        return self.cols.dims.get(name)

    def numeric(self, name: str) -> torch.Tensor:
        if name in self.virtual:
            return self.virtual[name]
        if name in self.cols.metrics:
            return self.cols.metrics[name][1]
        raise KeyError(f"no numeric column {name!r}")


def filter_mask(f: Optional[dict], rows: Rows) -> Optional[torch.Tensor]:
    if f is None:
        return None
    t = f["type"]
    if t in ("and", "or"):
        masks = [filter_mask(g, rows) for g in f["fields"]]
        out = masks[0]
        for m in masks[1:]:
            out = (out & m) if t == "and" else (out | m)
        return out
    if t == "not":
        return ~filter_mask(f["field"], rows)
    ids = rows.dim(f["dimension"])
    if ids is None:
        return _numeric_mask(f, rows.numeric(f["dimension"]))
    test = _value_test(f)
    lut = torch.tensor([bool(test(v)) for v in rows.values[f["dimension"]]],
                       device=ids.device, dtype=torch.bool)
    return lut[ids]


_TOKEN = re.compile(r"\s*([A-Za-z_][A-Za-z_0-9]*|\d+(?:\.\d*)?|[-+*/()])")


def eval_expression(expr: str, rows: Rows, out_type: str) -> torch.Tensor:
    """+, -, * and / over columns and numbers, with the usual precedence;
    LONG math in int64 (division truncates), DOUBLE math in float64."""
    toks = _TOKEN.findall(expr)
    if "".join(toks) != re.sub(r"\s+", "", expr):
        raise NotImplementedError(f"expression {expr!r}")
    dtype = torch.int64 if out_type.upper() == "LONG" else torch.float64
    pos = [0]

    def atom():
        tok = toks[pos[0]]
        pos[0] += 1
        if tok == "(":
            v = add()
            pos[0] += 1
            return v
        if tok[0].isdigit():
            return torch.tensor(float(tok) if "." in tok else int(tok),
                                dtype=dtype)
        return rows.numeric(tok).to(dtype)

    def mul():
        v = atom()
        while pos[0] < len(toks) and toks[pos[0]] in "*/":
            op = toks[pos[0]]
            pos[0] += 1
            w = atom()
            v = v * w if op == "*" else (
                torch.div(v, w, rounding_mode="trunc")
                if dtype == torch.int64 else v / w)
        return v

    def add():
        v = mul()
        while pos[0] < len(toks) and toks[pos[0]] in "+-":
            op = toks[pos[0]]
            pos[0] += 1
            w = mul()
            v = v + w if op == "+" else v - w
        return v
    return add()


# ---------------------------------------------------------------------------
# One query over every segment
# ---------------------------------------------------------------------------

_SUMS = {"longSum": "long", "doubleSum": "double", "count": "long"}


class QueryTable:
    """The dense table of one query: a cell for each (bucket, dim ids)."""

    def __init__(self, query: dict, cfg: dict, values, device,
                 precision: str):
        self.q = query
        self.qtype = query["queryType"]
        if self.qtype not in ("timeseries", "groupBy", "topN"):
            raise NotImplementedError(f"query type {self.qtype!r}")
        self.ivs = intervals_ms(query)
        self.gran = granularity_of(query)
        first, last = common.day_of(cfg["first_day"]), \
            common.day_of(cfg["last_day"])
        self.buckets = [0] if self.gran == "all" else \
            bucket_list(self.gran, self.ivs, first, last)
        self.dims = dim_names(query)
        self.values = values
        self.cards = [len(values[d]) for d in self.dims]
        cells = len(self.buckets) * math.prod(self.cards)
        if cells > DENSE_LIMIT:
            raise ValueError(f"{cells} cells: too many for a dense table")
        self.cells = cells
        self.device = device
        self.precision = precision
        self.count = torch.zeros(cells, dtype=self._acc("long"),
                                 device=device)
        self.aggs = []
        for a in query.get("aggregations", []):
            kind = _SUMS.get(a["type"])
            if kind is None:
                raise NotImplementedError(f"aggregator {a['type']!r}")
            self.aggs.append((a, kind, torch.zeros(
                cells, dtype=self._acc(kind), device=device)))

    def _acc(self, kind: str) -> torch.dtype:
        if self.precision == "float32":
            return torch.float32
        return torch.int64 if kind == "long" else torch.float64

    def overlaps(self, spec: common.SegmentSpec) -> bool:
        return any(a < spec.end_ms and b > spec.start_ms
                   for a, b in self.ivs)

    def add(self, rows: Rows) -> None:
        cols = rows.cols
        t_ms = cols.time_day * common.DAY_MS
        live = torch.zeros_like(t_ms, dtype=torch.bool)
        for a, b in self.ivs:
            live |= (t_ms >= a) & (t_ms < b)
        rows.virtual = {}
        for vc in self.q.get("virtualColumns", []):
            if vc.get("type") != "expression":
                raise NotImplementedError(f"virtual column {vc!r}")
            rows.virtual[vc["name"]] = eval_expression(
                vc["expression"], rows, vc.get("outputType", "DOUBLE"))
        fm = filter_mask(self.q.get("filter"), rows)
        if fm is not None:
            live &= fm
        if self.gran == "all":
            key = torch.zeros_like(t_ms)
        else:
            bl = torch.tensor(self.buckets, device=t_ms.device,
                              dtype=torch.int64)
            b = bucket_days(self.gran, cols.time_day)
            key = torch.searchsorted(bl, b)
        for d, card in zip(self.dims, self.cards):
            key = key * card + rows.dim(d)
        key = key[live]
        self.count.index_add_(0, key, torch.ones_like(
            key, dtype=self.count.dtype))
        for a, kind, acc in self.aggs:
            if a["type"] == "count":
                acc.index_add_(0, key, torch.ones_like(key, dtype=acc.dtype))
                continue
            v = rows.numeric(a["fieldName"])[live]
            src = v.to(torch.int64) if kind == "long" else v.to(torch.float64)
            acc.index_add_(0, key, src.to(acc.dtype))

    def answer(self) -> Dict[tuple, Dict[str, object]]:
        """{(bucket ms, dim values...): {name: value}}; topN keeps its
        top `threshold` of each bucket by its metric."""
        count = self.count.cpu()
        held = torch.nonzero(count > 0).flatten()
        if self.qtype == "timeseries":
            held = torch.arange(self.cells)      # every bucket, zero-filled
        vals = [acc.cpu()[held] for _, _, acc in self.aggs]
        out = {}
        strides = []
        s = 1
        for card in reversed(self.cards):
            strides.append(s)
            s *= card
        strides.reverse()
        for j, cell in enumerate(held.tolist()):
            key = [self._bucket_ms(cell // s)]
            rem = cell % s
            for d, st, card in zip(self.dims, strides, self.cards):
                key.append(self.values[d][(rem // st) % card])
            row = {}
            for (a, kind, _), v in zip(self.aggs, vals):
                x = v[j].item()
                if kind == "long":
                    x = int(round(x))
                row[a["name"]] = x
            for p in self.q.get("postAggregations", []):
                row[p["name"]] = post_aggregate(p, row)
            out[tuple(key)] = row
        if self.qtype == "topN":
            out = top_n(out, self.q)
        return out

    def _bucket_ms(self, b: int) -> int:
        if self.gran == "all":
            return self.ivs[0][0]
        return self.buckets[b] * common.DAY_MS


def dim_names(query: dict) -> List[str]:
    if query["queryType"] == "topN":
        d = query["dimension"]
        return [d if isinstance(d, str) else d["dimension"]]
    out = []
    for d in query.get("dimensions", []):
        if isinstance(d, str):
            out.append(d)
        elif d.get("type", "default") == "default" and \
                d.get("outputName", d["dimension"]) == d["dimension"]:
            out.append(d["dimension"])
        else:
            raise NotImplementedError(f"dimension spec {d!r}")
    return out


def post_aggregate(p: dict, row: dict):
    t = p["type"]
    if t == "fieldAccess":
        return row[p["fieldName"]]
    if t == "constant":
        return p["value"]
    if t == "arithmetic":
        xs = [float(post_aggregate(f, row)) for f in p["fields"]]
        fn = p["fn"]
        acc = xs[0]
        for x in xs[1:]:
            if fn == "+":
                acc += x
            elif fn == "-":
                acc -= x
            elif fn == "*":
                acc *= x
            elif fn == "/":
                acc = 0.0 if x == 0 else acc / x
            elif fn == "quotient":
                acc = acc / x
            else:
                raise NotImplementedError(f"arithmetic fn {fn!r}")
        return acc
    raise NotImplementedError(f"post-aggregator {t!r}")


def top_n(table: Dict[tuple, dict], query: dict) -> Dict[tuple, dict]:
    metric = query["metric"]
    if not isinstance(metric, str):
        raise NotImplementedError(f"topN metric spec {metric!r}")
    n = int(query["threshold"])
    by_bucket: Dict[int, list] = {}
    for key, row in table.items():
        by_bucket.setdefault(key[0], []).append((key, row))
    out = {}
    for _, items in sorted(by_bucket.items()):
        items.sort(key=lambda kr: -kr[1][metric])
        for key, row in items[:n]:
            out[key] = row
    return out


# ---------------------------------------------------------------------------
# The whole mix
# ---------------------------------------------------------------------------

def answers(cfg: dict, queries: Sequence[dict], seed: int, device,
            precision: str = "exact") -> List[Dict[tuple, dict]]:
    """The reference's answer to each query, one segment at a time."""
    gen = generator_module(cfg)
    values = gen.value_lists()
    tables = [QueryTable(q, cfg, values, device, precision)
              for q in queries]
    for spec in common.layout(cfg):
        live = [t for t in tables if t.overlaps(spec)]
        if not live:
            continue
        rows = Rows(gen.generate(cfg, seed, spec, device), values)
        for t in live:
            t.add(rows)
    return [t.answer() for t in tables]


# ---------------------------------------------------------------------------
# Reading a reply and holding it against the reference
# ---------------------------------------------------------------------------

def _ts(v) -> int:
    return int(v) if isinstance(v, (int, float)) else parse_ms(str(v))


def normalize(query: dict, reply) -> Dict[tuple, dict]:
    """A reply's rows (Druid's JSON) as {(bucket ms, dims...): values}."""
    dims = dim_names(query)
    out = {}
    qt = query["queryType"]
    for r in reply:
        ts = _ts(r["timestamp"])
        if qt == "timeseries":
            out[(ts,)] = dict(r["result"])
        elif qt == "topN":
            for e in r["result"]:
                e = dict(e)
                key = (ts,) + tuple(e.pop(d, None) for d in dims)
                out[key] = e
        else:
            e = dict(r["event"])
            key = (ts,) + tuple(e.pop(d, None) for d in dims)
            out[key] = e
    return out


@dataclass
class Verdict:
    """What one comparison found: keys present on one side only, exact
    values that differ, and the widest relative gap of inexact ones."""
    keys_wrong: int = 0
    exact_wrong: int = 0
    rel_err: float = 0.0

    def merge(self, other: "Verdict") -> None:
        self.keys_wrong += other.keys_wrong
        self.exact_wrong += other.exact_wrong
        self.rel_err = max(self.rel_err, other.rel_err)


def compare(got: Dict[tuple, dict], want: Dict[tuple, dict]) -> Verdict:
    """Integers in the reference (counts, LONG sums) must match exactly;
    floats are held by their relative gap."""
    v = Verdict()
    v.keys_wrong = len(set(got) ^ set(want))
    for key in set(got) & set(want):
        g, w = got[key], want[key]
        for name, wv in w.items():
            gv = g.get(name)
            if gv is None or isinstance(gv, (str, list, dict)):
                v.exact_wrong += 1
            elif isinstance(wv, int) and not isinstance(wv, bool):
                v.exact_wrong += int(gv != wv)
            else:
                gap = abs(float(gv) - float(wv))
                if gap:
                    v.rel_err = max(v.rel_err,
                                    gap / max(abs(float(wv)), 1e-300))
        v.exact_wrong += len(set(g) - set(w))
    return v
