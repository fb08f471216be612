"""The least time a query's scan can take: its logical input bytes at the
card's peak memory rate.

Logical input bytes are the rows in the query's intervals times the
logical width of each column it reads, each column counted once: a
string dimension's int32 ids 4 B, LONG 8 B, FLOAT 4 B, DOUBLE 8 B and
`__time` 8 B. `__time` counts where the query needs it: a granularity
other than all, or an interval that cuts a segment. The count is the
same whatever encoding or kernel serves the query.
"""
from __future__ import annotations

from typing import Dict, Iterable, Set

from portbench.gen import common

#: peak memory bandwidth, bytes/s, by `torch.cuda.get_device_name()`
#: (NVIDIA's data sheets, at the full power limit)
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

WIDTH = {"dim": 4, "long": 8, "float": 4, "double": 8}
TIME_WIDTH = 8


def widths(columns: common.Columns) -> Dict[str, int]:
    """Logical width of each column a generator makes."""
    out = {d: WIDTH["dim"] for d in columns.dims}
    out.update({m: WIDTH[vt] for m, (vt, _) in columns.metrics.items()})
    return out


def _filter_columns(f, out: Set[str]) -> None:
    if not f:
        return
    if "fields" in f:
        for g in f["fields"]:
            _filter_columns(g, out)
    elif "field" in f:
        _filter_columns(f["field"], out)
    elif "dimension" in f:
        out.add(f["dimension"])


def _expression_columns(expr: str, known: Iterable[str]) -> Set[str]:
    import re
    names = set(re.findall(r"[A-Za-z_][A-Za-z_0-9]*", expr))
    return names & set(known)


def columns_read(query: dict, known: Iterable[str]) -> Set[str]:
    """The stored columns a query reads (virtual columns resolved to
    their inputs)."""
    known = set(known)
    wanted: Set[str] = set()
    if query["queryType"] == "topN":
        d = query["dimension"]
        wanted.add(d if isinstance(d, str) else d["dimension"])
    for d in query.get("dimensions", []):
        wanted.add(d if isinstance(d, str) else d["dimension"])
    _filter_columns(query.get("filter"), wanted)
    for a in query.get("aggregations", []):
        if "fieldName" in a:
            wanted.add(a["fieldName"])
    virtual = {v["name"]: v for v in query.get("virtualColumns", [])}
    out = set()
    for c in wanted:
        if c in virtual:
            out |= _expression_columns(virtual[c]["expression"], known)
        elif c in known:
            out.add(c)
    return out


def needs_time(query: dict, cfg: dict, ivs) -> bool:
    """Whether `__time` is read: a granularity other than all, or a
    segment only part of whose rows the intervals cover."""
    gran = query.get("granularity", "all")
    if (gran if isinstance(gran, str) else gran.get("type")) != "all":
        return True
    for s in common.layout(cfg):
        held = common.rows_in_intervals(cfg, [(s.start_ms, s.end_ms)])
        cut = [(max(a, s.start_ms), min(b, s.end_ms)) for a, b in ivs
               if a < s.end_ms and b > s.start_ms]
        if 0 < common.rows_in_intervals(cfg, cut) < held:
            return True
    return False


def logical_bytes(query: dict, cfg: dict, width: Dict[str, int],
                  ivs) -> int:
    """Rows in the intervals x the logical widths of the columns read."""
    rows = common.rows_in_intervals(cfg, ivs)
    per_row = sum(width[c] for c in columns_read(query, width))
    if needs_time(query, cfg, ivs):
        per_row += TIME_WIDTH
    return rows * per_row
