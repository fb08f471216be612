"""One run of one cell: the port's cluster built from the seed, its
window driven over HTTP by closed-loop clients, the metrics read, and
the replies held against the plain reference.

The program is `druid_tpu_torch` alone: in-process `DataNode`s holding
the week segments, behind a `Broker` behind
`QueryHttpServer(QueryLifecycle(broker))`; the clients post native JSON
to its `/druid/v2` from a child process (`clients.py`).

A configuration's `layout` block decides the cluster and the cards the
run measures (`Layout.of`); a key left out takes its default:

- `chips`: the cards (1). It may not exceed the cell's `chips`;
- `data_nodes`: the in-process data nodes (2); segment i goes to node
  i mod `data_nodes`;
- `mesh`: the cards of each node's mesh (absent or 0: no mesh). `chips`
  must be a multiple of it. Node i holds cards (i*m .. i*m+m-1) mod
  `chips`, runs on the first and shards its aggregates over all of them
  (`DataNode(mesh=)`); without a mesh node i sits on card i mod `chips`.
  Nodes may share cards. The broker sits on card 0.

On the CPU (the tests) every node runs on the one CPU device, a mesh of
m being m CPU shards (`make_mesh(m, device="cpu")`). The held bytes are
summed over the layout's cards, the peak is the fullest card's, and the
device trace reads each card apart (`devtrace.py`).
"""
from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch

from portbench import reference, registry, roofline
from portbench.gen import common

GRACE_S = 60.0                  # a query in flight at the close may finish
START_LEAD_S = 0.5              # the clients' process starts inside this
SLICE = (0.2, 0.8)              # the traced share of the window
FORBIDDEN = ("jax", "jaxlib", "flax", "druid_tpu")


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# The program under test
# ---------------------------------------------------------------------------

def make_segments(cfg: dict, seed: int, device) -> tuple:
    """Each week's columns made on `device` from the seed, then handed to
    the port as host arrays (`segment_from_arrays`), with each segment's
    dictionary of the values present in it, sorted. Returns (segments,
    logical widths, seconds generating, seconds building)."""
    from druid_tpu_torch.data.convert import segment_from_arrays
    gen = reference.generator_module(cfg)
    values = gen.value_lists()
    ranks, ordered = {}, {}
    for name, vs in values.items():
        order = sorted(range(len(vs)), key=vs.__getitem__)
        rank = [0] * len(vs)
        for pos, i in enumerate(order):
            rank[i] = pos
        ranks[name] = torch.tensor(rank, dtype=torch.int64, device=device)
        ordered[name] = [vs[i] for i in order]
    segments, width, t_gen, t_build = [], None, 0.0, 0.0
    for spec in common.layout(cfg):
        t = time.perf_counter()
        cols = gen.generate(cfg, seed, spec, device)
        if width is None:
            width = roofline.widths(cols)
        dims = {}
        for name, ids in cols.dims.items():
            present, local = torch.unique(ranks[name][ids],
                                          return_inverse=True)
            dims[name] = (local.to(torch.int32).cpu().numpy(),
                          [ordered[name][p] for p in present.tolist()])
        metrics = {}
        for name, (vt, x) in cols.metrics.items():
            metrics[name] = (vt, x.to(torch.int64 if vt == "long"
                                       else torch.float32).cpu().numpy())
        time_ms = (cols.time_day * common.DAY_MS).cpu().numpy()
        del cols
        t2 = time.perf_counter()
        segments.append(segment_from_arrays(
            time_ms, dims, metrics, cfg["datasource"],
            (spec.start_ms, spec.end_ms)))
        t_gen += t2 - t
        t_build += time.perf_counter() - t2
    return segments, width, t_gen, t_build


@dataclass(frozen=True)
class Layout:
    """The cluster a configuration asks for (the module's docstring)."""
    chips: int = 1
    data_nodes: int = 2
    mesh: int = 0

    @classmethod
    def of(cls, cfg: dict, chips: Optional[int] = None) -> "Layout":
        """The configuration's layout, checked against the cell's `chips`
        (default: the layout's own); raises ValueError before any set-up
        where it cannot be built."""
        block = cfg.get("layout", {})
        out = cls(**{k: int(block.get(k, getattr(cls, k)))
                     for k in ("chips", "data_nodes", "mesh")})
        name = cfg.get("name", "?")
        if out.chips < 1 or out.data_nodes < 1 or out.mesh < 0:
            raise ValueError(f"configuration {name}: layout {out} needs "
                             "chips and data_nodes of 1 or more, mesh of 0 "
                             "or more")
        if chips is not None and out.chips > chips:
            raise ValueError(f"configuration {name}: its layout asks for "
                             f"{out.chips} cards, the cell for {chips}")
        if out.mesh and out.chips % out.mesh:
            raise ValueError(f"configuration {name}: {out.chips} cards are "
                             f"not a multiple of a mesh of {out.mesh}")
        return out

    def node_cards(self, i: int) -> List[int]:
        """The cards data node i holds: its mesh's, or its one."""
        if self.mesh:
            return [(i * self.mesh + j) % self.chips
                    for j in range(self.mesh)]
        return [i % self.chips]

    def cards(self, kind: str) -> List[torch.device]:
        """The devices the run measures: the layout's cards, or the CPU."""
        if kind == "cpu":
            return [torch.device("cpu")]
        return [torch.device(kind, i) for i in range(self.chips)]


def placement(layout: Layout, kind: str) -> List[tuple]:
    """(device, mesh or None) of each data node."""
    from druid_tpu_torch.parallel.context import Mesh, make_mesh
    out = []
    for i in range(layout.data_nodes):
        idx = layout.node_cards(i)
        if kind == "cpu":
            mesh = make_mesh(layout.mesh, device="cpu") if layout.mesh \
                else None
            out.append((torch.device("cpu"), mesh))
        else:
            devs = tuple(torch.device(kind, k) for k in idx)
            out.append((devs[0], Mesh(devs) if layout.mesh else None))
    return out


class Program:
    """The port's serving stack over the segments, placed as `layout`
    says on devices of `kind` ("cuda" or "cpu")."""

    def __init__(self, segments, kind, layout: Layout = Layout()):
        from druid_tpu_torch.cluster import Broker, DataNode, InventoryView
        from druid_tpu_torch.cluster.view import descriptor_for
        from druid_tpu_torch.server import QueryHttpServer, QueryLifecycle
        kind = torch.device(kind).type
        self.view = InventoryView()
        self.nodes = [DataNode(f"historical-{i}", device=dev, mesh=mesh)
                      for i, (dev, mesh) in enumerate(placement(layout,
                                                                kind))]
        for node in self.nodes:
            self.view.register(node)
        for i, seg in enumerate(segments):
            node = self.nodes[i % len(self.nodes)]
            node.load_segment(seg)
            self.view.announce(node.name, descriptor_for(seg))
        self.broker = Broker(self.view, device=layout.cards(kind)[0])
        self.http = QueryHttpServer(QueryLifecycle(self.broker)).start()
        self.url = f"http://127.0.0.1:{self.http.port}/druid/v2"

    def stop(self) -> None:
        self.http.stop()
        self.broker.stop()
        for node in self.nodes:
            for sid in list(node.served_segment_ids()):
                node.drop_segment(sid)
        self.nodes, self.view, self.broker, self.http = [], None, None, None


def allocated_bytes(cards: Sequence[torch.device]) -> Optional[int]:
    """The cards' allocated bytes summed, each once its queue has drained
    (the caching allocator's count: tensors alive, not blocks cached);
    None off a card."""
    if cards[0].type != "cuda":
        return None
    total = 0
    for card in cards:
        torch.cuda.synchronize(card)
        total += torch.cuda.memory_allocated(card)
    return total


def peak_bytes(cards: Sequence[torch.device]) -> List[int]:
    """Each card's peak allocated bytes since the process started (0 off
    a card)."""
    return [torch.cuda.max_memory_allocated(c) if c.type == "cuda" else 0
            for c in cards]


def pool_snapshot():
    from druid_tpu_torch.data.devicepool import device_pool
    return device_pool().snapshot()


def batch_counts() -> Dict[str, float]:
    from druid_tpu_torch.engine import batching
    return batching.stats().snapshot()


def free_program_state() -> None:
    from druid_tpu_torch.data.devicepool import device_pool
    from druid_tpu_torch.engine import release_device_caches
    device_pool().clear()
    release_device_caches()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class StrategyLog:
    """Records the reduction strategy of each plan while installed (the
    warm-up only: the window runs the program untouched)."""

    def __init__(self):
        from druid_tpu_torch.engine import grouping
        self.grouping = grouping
        self.seen: Dict[str, int] = {}
        self._orig = grouping.select_strategy
        self._lock = threading.Lock()

    def __enter__(self):
        def wrapped(spec, *a, **k):
            out = self._orig(spec, *a, **k)
            key = f"{out[0]}(G {getattr(spec, 'num_total', '?')})"
            with self._lock:
                self.seen[key] = self.seen.get(key, 0) + 1
            return out
        self.grouping.select_strategy = wrapped
        return self

    def __exit__(self, *exc):
        self.grouping.select_strategy = self._orig

    def take(self) -> Dict[str, int]:
        out, self.seen = self.seen, {}
        return out


# ---------------------------------------------------------------------------
# What a run hands to the metric readers
# ---------------------------------------------------------------------------

@dataclass
class Query:
    """One query of the mix, with what the benchmark counts of it."""
    name: str
    json: dict
    rows: int                   # rows in its intervals, before filters
    logical_bytes: int


@dataclass
class RunData:
    cell: str
    cfg: dict
    queries: List[Query]
    seconds: float
    window: tuple               # (start, end), wall clock s
    records: List[dict]
    setup_s: float
    held_rows: int
    held_bytes: Optional[int]   # the cards' allocated bytes the warm-up left
    batches: Dict[str, float] = field(default_factory=dict)
    spans: Dict[str, List[dict]] = field(default_factory=dict)
    trace: Optional[object] = None       # devtrace.DeviceTrace
    device_name: str = ""

    def completed(self) -> List[dict]:
        """Queries answered (200) whose reply came inside the window."""
        return [r for r in self.records if r["status"] == 200
                and r["t_done"] is not None and r["t_done"] <= self.window[1]]

    def sent_in_window(self) -> List[dict]:
        """Every query the window sent, answered or not, those answered
        after the close included."""
        return [r for r in self.records if r["t_send"] < self.window[1]]

    def latencies_ms(self) -> List[float]:
        """Latency of every query the window sent and that was answered
        (200): the slow ones still in flight at the close are waited for,
        so the sample holds each query of the mix in its share."""
        return [(r["t_done"] - r["t_send"]) * 1e3
                for r in self.sent_in_window() if r["status"] == 200]


def percentile(values: List[float], p: float) -> float:
    """Nearest-rank percentile."""
    xs = sorted(values)
    k = max(0, -(-len(xs) * p // 100) - 1)
    return xs[int(k)]


def median(values: List[float]) -> Optional[float]:
    return statistics.median(values) if values else None


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------

def _post(url: str, query: dict) -> dict:
    from portbench import clients
    status, body = clients.post(url, json.dumps(query).encode(), 600.0)
    if status != 200:
        raise RuntimeError(f"warm-up query failed ({status}): "
                           f"{body[:2000]!r}")
    return json.loads(body)


def card_line(device) -> str:
    if device.type != "cuda":
        return "device cpu"
    name = torch.cuda.get_device_name(device)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = "nvidia-smi not available"
    return f"card {name}; nvidia-smi: {smi}"


def run_cell(cell: str, cfg: dict, mix: dict, seed: int, seconds: float,
             trace: bool, device, metric_specs: List[dict], limits: dict,
             t0: float, chips: Optional[int] = None) -> dict:
    """Everything after the card check, on devices of `device`'s type
    ("cuda" or "cpu"), the cell holding `chips` cards (default: its
    layout's). Returns the result object (the last line's keys) with the
    checks last."""
    layout = Layout.of(cfg, chips)
    cards = layout.cards(torch.device(device).type)
    device = cards[0]
    log(card_line(device))
    log(f"layout: {layout}; data nodes on cards "
        f"{[layout.node_cards(i) for i in range(layout.data_nodes)]}, "
        "the broker on card 0")
    if mix["datasource"] != cfg["datasource"]:
        raise ValueError(f"mix {mix['name']} queries {mix['datasource']}, "
                         f"configuration {cfg['name']} holds "
                         f"{cfg['datasource']}")
    ctx = {**mix.get("context", {}), "trace": bool(trace)}
    queries_json = [{**q["query"], "context": {**q["query"].get("context",
                                                               {}), **ctx}}
                    for q in mix["queries"]]

    segments, width, t_gen, t_build = make_segments(cfg, seed, device)
    held_rows = sum(s.n_rows for s in segments)
    log(f"set-up: {len(segments)} segments, {held_rows} rows; generated "
        f"and copied to the host in {t_gen:.3f} s, built in "
        f"{t_build:.3f} s")
    queries = []
    for q, qj in zip(mix["queries"], queries_json):
        ivs = reference.intervals_ms(qj)
        queries.append(Query(q["name"], qj,
                             common.rows_in_intervals(cfg, ivs),
                             roofline.logical_bytes(qj, cfg, width, ivs)))
    base = allocated_bytes(cards)
    t = time.time()
    program = Program(segments, device.type, layout)
    del segments
    log(f"set-up: program started in {time.time() - t:.3f} s")
    t = time.time()
    with StrategyLog() as strategies:
        for q in queries:
            tq = time.time()
            _post(program.url, q.json)
            log(f"warm {q.name}: {time.time() - tq:.3f} s, strategies "
                f"{strategies.take()}")
    held = allocated_bytes(cards)
    log(f"set-up: warm-up in {time.time() - t:.3f} s")
    pool = pool_snapshot()
    log(f"pool after warm-up: resident {pool.resident_bytes} B, evicted "
        f"{pool.evicted_bytes} B, logical {pool.logical_bytes} B; "
        f"{len(cards)} card(s) allocated {held} B over the {base} B before "
        "the program")

    recorder = dev_trace = None
    if trace:
        from druid_tpu_torch.obs.trace import trace_store

        from portbench import devtrace
        trace_store().max_traces = max(trace_store().max_traces, 1 << 20)
        # before the window's start is fixed: the profiler's start holds
        # the process for seconds
        recorder = devtrace.Recorder(device.type)
    batches0 = batch_counts()
    start = time.time() + START_LEAD_S
    spec = {"url": program.url, "clients": int(mix["clients"]),
            "seed": int(seed), "start": start, "seconds": float(seconds),
            "grace_s": GRACE_S,
            "queries": [{"name": q.name, "query": q.json} for q in queries]}
    setup_s = start - t0
    child = subprocess.Popen(
        [sys.executable, str(registry.HERE / "clients.py")],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        child.stdin.write(json.dumps(spec))
        child.stdin.close()
        if recorder is not None:
            dev_trace = recorder.stop((start + SLICE[0] * seconds,
                                       start + SLICE[1] * seconds),
                                      [c.index or 0 for c in cards])
        out = child.stdout.read()       # the clients end by their deadline
        child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    got = json.loads(out)
    records = got["records"]
    window = (start, start + seconds)
    peaks = peak_bytes(cards)
    log("peak allocated bytes by card: " + json.dumps(
        {str(c): p for c, p in zip(cards, peaks)}))
    batches1 = batch_counts()
    spans = {}
    if trace:
        from druid_tpu_torch.obs.trace import trace_store
        spans = {r["qid"]: trace_store().spans(r["qid"]) for r in records}
    run = RunData(
        cell=cell, cfg=cfg, queries=queries, seconds=float(seconds),
        window=window, records=records, setup_s=setup_s,
        held_rows=held_rows,
        held_bytes=None if held is None else held - base,
        batches={k: batches1[k] - batches0.get(k, 0) for k in batches1},
        spans=spans, trace=dev_trace,
        device_name=torch.cuda.get_device_name(device)
        if device.type == "cuda" else "cpu")
    done = run.completed()
    lat = {q.name: [round((r["t_done"] - r["t_send"]) * 1e3, 1)
                    for r in done if r["index"] == i]
           for i, q in enumerate(queries)}
    log("latency by query, ms: " + json.dumps(lat))
    log(f"window: {len(records)} sent, {len(done)} answered inside "
        f"{seconds} s, {sum(r['status'] != 200 for r in records)} failed; "
        "by query "
        + json.dumps({q.name: sum(r['index'] == i for r in done)
                      for i, q in enumerate(queries)}))
    metrics = {}
    for m in metric_specs:
        value = registry.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    program.stop()
    del program
    free_program_state()

    t = time.time()
    checks = check_replies(cfg, queries, records, seed, device, limits)
    log(f"reference: {time.time() - t:.3f} s over the regenerated columns")
    failed = [r for r in records if r["status"] != 200]
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": len(records), "failed": len(failed),
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type,
                         "kind": run.device_name,
                         "count": layout.chips,
                         "memory_peak_bytes": int(max(peaks))}}
    if dev_trace is not None:
        log("busy s by card: " + json.dumps(
            {f"card{c}": dev_trace.card_busy_s(c) for c in dev_trace.cards})
            + f" of a {dev_trace.window_s} s slice")
        result["device"]["busy_s"] = dev_trace.busy_s
        result["device"]["window_s"] = dev_trace.window_s
        result["breakdown"] = dev_trace.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def check_replies(cfg: dict, queries: List[Query], records: List[dict],
                  seed: int, device, limits: dict) -> Dict[str, tuple]:
    """Every reply of the run held against the reference's answer to its
    query: (value, limit) by check."""
    want = reference.answers(cfg, [q.json for q in queries], seed, device)
    verdict = reference.Verdict()
    wrong = lost = failed = 0
    for r in records:
        if r["status"] is None:
            lost += 1
            continue
        if r["status"] != 200:
            failed += 1
            continue
        q = queries[r["index"]]
        v = reference.compare(reference.normalize(q.json,
                                                  json.loads(r["body"])),
                              want[r["index"]])
        wrong += int(v.keys_wrong + v.exact_wrong > 0)
        verdict.merge(v)
    log(f"checked {len(records)} replies: {verdict.keys_wrong} keys and "
        f"{verdict.exact_wrong} exact values wrong, widest relative gap "
        f"{verdict.rel_err!r}")
    return {"answers_wrong": (wrong, 0), "answers_lost": (lost, 0),
            "answers_failed": (failed, 0),
            "rel_err_max": (verdict.rel_err, float(limits["rel_err_max"]))}


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names of JAX or the JAX package among the loaded modules
    (default: `sys.modules`), compared whole: the port's name begins with
    the JAX package's."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
