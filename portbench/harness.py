"""One run of one cell: the port's cluster built from the seed, its
window driven over HTTP by closed-loop clients, the metrics read, and
the replies held against the plain reference.

The program is `druid_tpu_torch` alone: two in-process `DataNode`s,
holding alternate week segments, behind a `Broker` behind
`QueryHttpServer(QueryLifecycle(broker))`; the clients post native JSON
to its `/druid/v2` from a child process (`clients.py`).
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
from typing import Dict, List, Optional

import torch

from portbench import reference, registry, roofline
from portbench.gen import common

DATA_NODES = 2
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


class Program:
    """The port's serving stack over the segments."""

    def __init__(self, segments, device):
        from druid_tpu_torch.cluster import Broker, DataNode, InventoryView
        from druid_tpu_torch.cluster.view import descriptor_for
        from druid_tpu_torch.server import QueryHttpServer, QueryLifecycle
        self.view = InventoryView()
        self.nodes = [DataNode(f"historical-{i}", device=device)
                      for i in range(DATA_NODES)]
        for node in self.nodes:
            self.view.register(node)
        for i, seg in enumerate(segments):
            node = self.nodes[i % DATA_NODES]
            node.load_segment(seg)
            self.view.announce(node.name, descriptor_for(seg))
        self.broker = Broker(self.view, device=device)
        self.http = QueryHttpServer(QueryLifecycle(self.broker)).start()
        self.url = f"http://127.0.0.1:{self.http.port}/druid/v2"

    def stop(self) -> None:
        self.http.stop()
        self.broker.stop()
        for node in self.nodes:
            for sid in list(node.served_segment_ids()):
                node.drop_segment(sid)
        self.nodes, self.view, self.broker, self.http = [], None, None, None


def allocated_bytes(device) -> Optional[int]:
    """The card's allocated bytes once its queue has drained (the caching
    allocator's count: tensors alive, not blocks cached); None off a
    card."""
    if device.type != "cuda":
        return None
    torch.cuda.synchronize(device)
    return torch.cuda.memory_allocated(device)


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
    held_bytes: Optional[int]   # the card's allocated bytes the warm-up left
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
             t0: float) -> dict:
    """Everything after the card check. Returns the result object (the
    last line's keys) with the checks last."""
    device = torch.device(device)
    log(card_line(device))
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
    base = allocated_bytes(device)
    t = time.time()
    program = Program(segments, device)
    del segments
    log(f"set-up: program started in {time.time() - t:.3f} s")
    t = time.time()
    with StrategyLog() as strategies:
        for q in queries:
            tq = time.time()
            _post(program.url, q.json)
            log(f"warm {q.name}: {time.time() - tq:.3f} s, strategies "
                f"{strategies.take()}")
    held = allocated_bytes(device)
    log(f"set-up: warm-up in {time.time() - t:.3f} s")
    pool = pool_snapshot()
    log(f"pool after warm-up: resident {pool.resident_bytes} B, evicted "
        f"{pool.evicted_bytes} B, logical {pool.logical_bytes} B; card "
        f"allocated {held} B over the {base} B before the program")

    if trace:
        from druid_tpu_torch.obs.trace import trace_store
        trace_store().max_traces = max(trace_store().max_traces, 1 << 20)
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
        dev_trace = None
        if trace:
            from portbench import devtrace
            dev_trace = devtrace.record(start + SLICE[0] * seconds,
                                        (SLICE[1] - SLICE[0]) * seconds,
                                        device)
        out = child.stdout.read()       # the clients end by their deadline
        child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    got = json.loads(out)
    records = got["records"]
    window = (start, start + seconds)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
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
                         "count": 1, "memory_peak_bytes": int(peak)}}
    if dev_trace is not None:
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
