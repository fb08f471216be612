"""CLI: node commands + tools (the port's copy of the reference package's
`cli.py`).

Reference analog: services/src/main/java/org/apache/druid/cli/Main.java:52-112
— server commands (historical, broker, coordinator, overlord, …) and tools
(DumpSegment, ValidateSegments, CreateTables, ResetCluster).

`python -m druid_tpu_torch <command>`:
  server  — one process hosting the whole stack (metadata + coordinator +
            data nodes + broker + overlord + HTTP endpoints); the
            in-process analog of a single-server deployment
  historical, broker, coordinator (--ha), router — one role a process
  dump-segment     — segment introspection (cli/DumpSegment.java)
  segment inspect  — per-column storage report
  validate-segment — verify an on-disk segment loads and self-checks
  version

The commands whose nodes run queries (server, historical, broker, and
dump-segment --rows) take `--device`: the card (cuda) unless `--device cpu`
is given, as every entry point of the port. The configuration is the
`--config` file and the command line; the port reads no environment
(utils/config.py).
"""
from __future__ import annotations

import argparse
import json
import sys
import threading

VERSION = "druid-tpu-torch-0.1"

#: process-wide stop signal for the duty loops below. The loops park on
#: it (stop-responsive bounded waits) instead of time.sleep: SIGINT still
#: interrupts the wait on the main thread, and anything that sets the
#: event (tests, an embedding process) ends the duty loop within one
#: iteration — no thread ever parks un-wakeably.
_STOP = threading.Event()


def _scheduler_from_config(cfg):
    """`server.querySlots` bounds concurrent queries (0/unset = unbounded);
    `server.lanes` caps named lanes, e.g. "reports=1,adhoc=4"
    (DruidProcessingConfig numThreads + laning)."""
    slots = cfg.get_int("server.querySlots", 0)
    if not slots:
        return None
    from druid_tpu_torch.server.querymanager import QueryScheduler
    lanes = {}
    for part in (cfg.get("server.lanes") or "").split(","):
        name, _, cap = part.partition("=")
        if name.strip() and cap.strip().isdigit():
            lanes[name.strip()] = int(cap)
    return QueryScheduler(total_slots=slots, lanes=lanes)


def cmd_server(args) -> int:
    from druid_tpu_torch.cluster import (Broker, Coordinator, DataNode,
                                         DynamicConfig, InventoryView, LruCache,
                                         MetadataStore)
    from druid_tpu_torch.indexing import Overlord
    from druid_tpu_torch.server import QueryHttpServer, QueryLifecycle, RequestLogger
    from druid_tpu_torch.sql import SqlExecutor
    from druid_tpu_torch.storage.deep import LocalDeepStorage
    from druid_tpu_torch.utils.config import Config
    from druid_tpu_torch.utils.emitter import (MonitorScheduler, ProcessMonitor,
                                               ServiceEmitter, SysMonitor,
                                               emitter_from_config)
    import druid_tpu_torch.ext  # noqa: F401  (activate extensions)

    cfg = Config.load(args.config)
    metadata = MetadataStore(cfg.get("metadata.path", ":memory:"))
    deep = LocalDeepStorage(cfg.get("storage.dir", "./deep-storage"))
    view = InventoryView()
    n_nodes = cfg.get_int("server.dataNodes", 1)
    for i in range(n_nodes):
        view.register(DataNode(f"data{i}", device=args.device,
                               cache=LruCache()))
    coordinator = Coordinator(metadata, view, deep.pull, DynamicConfig())
    broker = Broker(view, cache=LruCache(), device=args.device)
    overlord = Overlord(metadata, deep)

    emitter = ServiceEmitter(
        "druid-tpu/server", "localhost",
        emitter_from_config(cfg.get("emitter.type", "noop"),
                            **cfg.subtree("emitter")
                            if cfg.get("emitter.type") == "file" else {}))
    logger = RequestLogger(cfg.get("request.log.path"))
    lifecycle = QueryLifecycle(broker, emitter, logger,
                               scheduler=_scheduler_from_config(cfg))
    sql = SqlExecutor(broker)
    http = QueryHttpServer(lifecycle, sql, port=cfg.get_int("server.port",
                                                            8082))
    monitors = MonitorScheduler(emitter, [SysMonitor(), ProcessMonitor()],
                                cfg.get_float("monitor.period", 60.0))

    # ordered bring-up/teardown (java-util Lifecycle): monitors and the
    # overlord pool before the HTTP server accepts, HTTP down first on stop
    from druid_tpu_torch.utils.lifecycle import Lifecycle, Stage
    lc = Lifecycle()
    lc.add(monitors, stage=Stage.NORMAL, name="monitors")
    lc.add(start=None, stop=overlord.shutdown, stage=Stage.NORMAL,
           name="overlord")
    lc.add(start=None, stop=broker.stop, stage=Stage.NORMAL, name="broker")
    lc.add(start=None, stop=coordinator.stop, stage=Stage.NORMAL,
           name="coordinator")
    lc.add(http, stage=Stage.SERVER, name="http")
    lc.start()
    print(f"druid-tpu-torch server listening on :{http.port} "
          f"({n_nodes} data node(s) on {view.nodes()[0].device})",
          flush=True)

    period = cfg.get_float("coordinator.period", 10.0)
    try:
        while not _STOP.is_set():
            coordinator.run_once()
            _STOP.wait(period)
    except KeyboardInterrupt:
        pass
    lc.stop()
    return 0


# ---------------------------------------------------------------------------
# Per-node-type servers (services/src/main/java/org/apache/druid/cli/
# CliHistorical.java, CliBroker.java, CliCoordinator.java, CliRouter.java) —
# each runs ONE role so deployments scale roles independently; `server`
# remains the single-process everything node.
# ---------------------------------------------------------------------------

def build_historical(name: str, segments_dir=None, port: int = 8083,
                     tier: str = "_default_tier", device=None):
    """DataNode + its HTTP query endpoint; optionally preload every
    persisted segment under segments_dir. device: the node's (None: the
    card)."""
    import os
    from druid_tpu_torch.cluster import DataNode, DataNodeServer, LruCache
    node = DataNode(name, tier=tier, cache=LruCache(), device=device)
    loaded = 0
    if segments_dir and os.path.isdir(segments_dir):
        from druid_tpu_torch.storage.format import load_segment
        from druid_tpu_torch.storage.smoosh import CorruptSegmentError
        for entry in sorted(os.listdir(segments_dir)):
            d = os.path.join(segments_dir, entry)
            if os.path.isfile(os.path.join(d, "version.bin")):
                try:
                    node.load_segment(load_segment(d))
                except CorruptSegmentError as e:
                    # skip-and-log: one damaged directory must not keep a
                    # historical from serving its healthy segments
                    print(f"skipping corrupt segment: {e}", file=sys.stderr,
                          flush=True)
                    continue
                loaded += 1
    server = DataNodeServer(node, port=port).start()
    return node, server, loaded


def cmd_historical(args) -> int:
    node, server, loaded = build_historical(
        args.name, args.segments_dir, args.port, args.tier, args.device)
    print(f"historical [{args.name}] listening on :{server.port} "
          f"({loaded} segments preloaded)", flush=True)
    try:
        while not _STOP.wait(3600):
            pass
    except KeyboardInterrupt:
        pass
    server.stop()
    return 0


def build_broker(data_node_urls, port: int = 8082, query_slots: int = 0,
                 lanes: str = "", device=None):
    """Broker over remote data nodes discovered via /status sync. device:
    where the broker's own work (a nested groupBy's outer query) runs
    (None: the card)."""
    from druid_tpu_torch.cluster import (Broker, InventoryView, LruCache,
                                         RemoteDataNodeClient)
    from druid_tpu_torch.server import QueryHttpServer, QueryLifecycle
    from druid_tpu_torch.sql import SqlExecutor
    from druid_tpu_torch.utils.config import Config
    view = InventoryView()
    for i, url in enumerate(data_node_urls):
        view.register(RemoteDataNodeClient(f"data{i}", url))
    view.sync_all()
    broker = Broker(view, cache=LruCache(), device=device)
    sched = _scheduler_from_config(Config.load(
        None, env={}, overrides={"server.querySlots": str(query_slots),
                                 "server.lanes": lanes}))
    lifecycle = QueryLifecycle(broker, scheduler=sched)
    http = QueryHttpServer(lifecycle, SqlExecutor(broker), port=port)
    http.start()
    return view, broker, http


def _reregister_missing(view, urls) -> None:
    """Configured nodes that were dropped by liveness re-register when
    they come back — a blip must not remove a statically-configured URL
    until process restart."""
    from druid_tpu_torch.cluster import RemoteDataNodeClient
    for i, url in enumerate(urls):
        name = f"data{i}"
        if view.node(name) is None:
            client = RemoteDataNodeClient(name, url)
            if client.ping():
                view.register(client)


def cmd_broker(args) -> int:
    urls = args.data_node or []
    view, broker, http = build_broker(urls, args.port,
                                      query_slots=args.query_slots,
                                      lanes=args.lanes, device=args.device)
    print(f"broker listening on :{http.port} "
          f"({len(urls)} data node(s))", flush=True)
    try:
        while not _STOP.is_set():
            view.check_liveness(failures_required=3)
            _reregister_missing(view, urls)
            view.sync_all()
            _STOP.wait(args.sync_period)
    except KeyboardInterrupt:
        pass
    http.stop()
    return 0


def cmd_coordinator(args) -> int:
    from druid_tpu_torch.cluster import (Coordinator, DynamicConfig, InventoryView,
                                         MetadataStore, RemoteDataNodeClient)
    from druid_tpu_torch.storage.deep import LocalDeepStorage
    metadata = MetadataStore(args.metadata)
    deep = LocalDeepStorage(args.storage_dir)
    view = InventoryView()
    for i, url in enumerate(args.data_node or []):
        view.register(RemoteDataNodeClient(f"data{i}", url))
    view.sync_all()
    leader = None
    if args.ha:
        # leader-elected HA: several coordinator processes share one
        # metadata file; the lease latch picks one, the rest stand by
        if args.metadata == ":memory:":
            # a private in-memory store per process = every process wins
            # its own election — the exact split-brain HA exists to prevent
            raise SystemExit(
                "--ha needs a SHARED lease store: pass --metadata "
                "/path/to/metadata.db (':memory:' is per-process)")
        from druid_tpu_torch.coordination import (LeaderParticipant,
                                                  MetadataLeaseStore)
        import socket
        node_id = args.node_id or f"{socket.gethostname()}-{id(view):x}"
        leader = LeaderParticipant(
            MetadataLeaseStore(metadata), "coordinator", node_id,
            lease_ms=args.lease_ms).start()
    coord = Coordinator(metadata, view, deep.pull, DynamicConfig(),
                        async_loading=True, leader=leader)
    print(f"coordinator running (period {args.period}s, "
          f"{len(args.data_node or [])} node(s)"
          + (f", HA node [{leader.node_id}]" if leader else "") + ")",
          flush=True)
    from druid_tpu_torch.cluster import StaleTermError
    try:
        while not _STOP.is_set():
            try:
                stats = coord.run_once()
            except StaleTermError as e:
                # deposed mid-cycle: the successor holds the term now —
                # drop back to standby and keep heartbeating, don't die
                print(f"deposed mid-cycle, standing by: {e}", flush=True)
                _STOP.wait(args.period)
                continue
            if not stats.skipped_not_leader:
                _reregister_missing(view, args.data_node or [])
                view.sync_all()
            if stats.assigned or stats.dropped or stats.nodes_removed:
                print(f"cycle: assigned={stats.assigned} "
                      f"dropped={stats.dropped} "
                      f"dead={stats.nodes_removed}", flush=True)
            _STOP.wait(args.period)
    except KeyboardInterrupt:
        pass
    if leader is not None:
        leader.stop()           # release the lease for fast failover
    coord.stop()
    return 0


def cmd_router(args) -> int:
    from druid_tpu_torch.server.router import RouterHttpServer, TieredBrokerSelector
    tiers = {}
    for spec in args.broker or []:
        tier, _, url = spec.partition("=")
        if not url:
            tier, url = "_default", spec
        tiers.setdefault(tier, []).append(url)
    if "_default" not in tiers:
        raise SystemExit("router needs at least one --broker [tier=]URL")
    selector = TieredBrokerSelector(tiers, default_tier="_default")
    http = RouterHttpServer(selector, port=args.port).start()
    print(f"router listening on :{http.port} "
          f"(tiers: {', '.join(sorted(tiers))})", flush=True)
    try:
        while not _STOP.wait(3600):
            pass
    except KeyboardInterrupt:
        pass
    http.stop()
    return 0


def cmd_dump_segment(args) -> int:
    """Segment forensics (cli/DumpSegment.java)."""
    from druid_tpu_torch.storage.format import load_segment, read_segment_meta
    meta = read_segment_meta(args.directory)
    out = {"metadata": meta}
    if args.rows:
        args.full = True   # --rows implies loading the segment
    if args.full:
        seg = load_segment(args.directory)
        cols = {}
        for name, col in seg.dims.items():
            cols[name] = {"type": "string",
                          "cardinality": col.cardinality,
                          "hasBitmapIndex": True}
        for name, m in seg.metrics.items():
            t = m.type.value if hasattr(m.type, "value") else str(m.type)
            cols[name] = {"type": t}
        out["columns"] = cols
        out["numRows"] = seg.n_rows
        out["interval"] = str(seg.interval)
        if args.rows:
            from druid_tpu_torch import device as device_mod
            from druid_tpu_torch.query.model import ScanQuery
            from druid_tpu_torch.engine.engines import run_scan
            batches = run_scan(
                ScanQuery.of(seg.id.datasource, [seg.interval],
                             limit=args.rows), [seg],
                device_mod.resolve(args.device))
            out["rows"] = [e for b in batches for e in b["events"]]
    print(json.dumps(out, indent=2, default=str))
    return 0


def cmd_segment_inspect(args) -> int:
    """Per-column storage forensics: encoding, descriptor, on-disk vs
    logical (decoded-equivalent) bytes — V1 and format-V2 segments."""
    import numpy as np
    from druid_tpu_torch.storage.format import (FORMAT_VERSION_V2,
                                                read_format_version,
                                                read_segment_meta)
    from druid_tpu_torch.storage.smoosh import SmooshedFileMapper
    version = read_format_version(args.directory)
    meta = read_segment_meta(args.directory)
    n_rows = int(meta["n_rows"])
    specs = (meta.get("v2") or {}).get("columns", {})
    fmt = 2 if version == FORMAT_VERSION_V2 else 1

    def logical(dtype_str):
        try:
            return n_rows * np.dtype(dtype_str).itemsize
        except TypeError:
            return None

    _TYPE_DTYPE = {"long": "int64", "float": "float32", "double": "float64"}
    columns = {}
    with SmooshedFileMapper(args.directory) as mapper:
        def size_of(*parts):
            return sum(mapper.part_size(p) for p in parts if mapper.has(p))

        for name in meta["dimensions"]:
            spec = specs.get(name, {"enc": "block", "dtype": "int32"})
            enc = spec["enc"]
            parts = {"rle": (f"col.{name}.rle.values",
                             f"col.{name}.rle.ends"),
                     "pack": (f"col.{name}.pack",),
                     "block": (f"dim.{name}.ids",)}[enc]
            desc = {k: v for k, v in spec.items() if k not in ("enc",)}
            columns[name] = {
                "kind": "dimension", "enc": enc, "descriptor": desc,
                "onDiskBytes": size_of(*parts),
                "logicalBytes": logical(spec.get("dtype", "int32")),
                "dictBytes": size_of(f"dim.{name}.dict"),
                "bitmapBytes": size_of(f"dim.{name}.bitmaps")}
        for name, tname in meta["metrics"].items():
            dt = _TYPE_DTYPE.get(tname)
            spec = specs.get(name, {"enc": "block", "dtype": dt})
            enc = spec["enc"]
            parts = {"rle": (f"col.{name}.rle.values",
                             f"col.{name}.rle.ends"),
                     "pack": (f"col.{name}.pack",),
                     "lz4": (f"col.{name}.lz4",),
                     "block": (f"met.{name}",)}[enc]
            desc = {k: v for k, v in spec.items() if k not in ("enc",)}
            columns[name] = {
                "kind": "metric", "type": tname, "enc": enc,
                "descriptor": desc, "onDiskBytes": size_of(*parts),
                "logicalBytes": logical(spec.get("dtype", dt))}
        time_disk = size_of("__time")
    out = {"directory": args.directory, "format": fmt, "numRows": n_rows,
           "columns": columns,
           "time": {"onDiskBytes": time_disk, "logicalBytes": n_rows * 8}}
    if fmt == 2:
        out["staging"] = meta["v2"].get("staging")
    disk = sum(c["onDiskBytes"] for c in columns.values()) + time_disk
    logi = sum(c["logicalBytes"] or 0 for c in columns.values()) + n_rows * 8
    out["totals"] = {"onDiskBytes": disk, "logicalBytes": logi,
                     "ratio": round(logi / disk, 2) if disk else None}
    print(json.dumps(out, indent=2, default=str))
    return 0


def cmd_validate_segment(args) -> int:
    """Load + self-check an on-disk segment (cli/ValidateSegments.java)."""
    from druid_tpu_torch.storage.format import load_segment
    try:
        seg = load_segment(args.directory)
    except Exception as e:
        print(f"INVALID: cannot load: {e}", file=sys.stderr)
        return 1
    problems = []
    n = seg.n_rows
    if len(seg.time_ms) != n:
        problems.append("time column length mismatch")
    for name, col in seg.dims.items():
        if len(col.ids) != n:
            problems.append(f"dim {name}: id column length {len(col.ids)}")
        if n and (col.ids.max() >= col.cardinality or col.ids.min() < 0):
            problems.append(f"dim {name}: id out of dictionary range")
        vals = col.dictionary.values
        if list(vals) != sorted(vals):
            problems.append(f"dim {name}: dictionary not sorted")
    for name, m in seg.metrics.items():
        if len(m.values) != n:
            problems.append(f"metric {name}: length {len(m.values)}")
    if n and not (seg.time_ms[:-1] <= seg.time_ms[1:]).all():
        problems.append("rows not time-sorted")
    if problems:
        print("INVALID: " + "; ".join(problems), file=sys.stderr)
        return 1
    print(f"OK: {seg.id} rows={n} dims={len(seg.dims)} "
          f"metrics={len(seg.metrics)}")
    return 0


def _device_arg(parser) -> None:
    parser.add_argument("--device", default=None,
                        help="torch device the node runs queries on "
                             "(default: the card, cuda; cpu runs the plain "
                             "PyTorch versions)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="druid_tpu_torch",
                                description="Druid's analytics engine on "
                                            "one CUDA card (PyTorch)")
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("server", help="run the single-process cluster")
    s.add_argument("--config", default=None, help="properties/json file")
    _device_arg(s)
    s.set_defaults(fn=cmd_server)

    s = sub.add_parser("historical", help="run one data-serving node")
    s.add_argument("--name", default="historical0")
    s.add_argument("--port", type=int, default=8083)
    s.add_argument("--tier", default="_default_tier")
    s.add_argument("--segments-dir", default=None,
                   help="preload persisted segments from this directory")
    _device_arg(s)
    s.set_defaults(fn=cmd_historical)

    s = sub.add_parser("broker", help="run the scatter-gather broker")
    s.add_argument("--port", type=int, default=8082)
    s.add_argument("--data-node", action="append",
                   help="data node base URL (repeatable)")
    s.add_argument("--sync-period", type=float, default=10.0)
    s.add_argument("--query-slots", type=int, default=0,
                   help="bound concurrent queries (0 = unbounded)")
    s.add_argument("--lanes", default="",
                   help='per-lane caps, e.g. "reports=1,adhoc=4"')
    _device_arg(s)
    s.set_defaults(fn=cmd_broker)

    s = sub.add_parser("coordinator", help="run the coordinator loop")
    s.add_argument("--metadata", default=":memory:",
                   help="sqlite path for the metadata store")
    s.add_argument("--storage-dir", default="./deep-storage")
    s.add_argument("--data-node", action="append")
    s.add_argument("--period", type=float, default=10.0)
    s.add_argument("--ha", action="store_true",
                   help="leader-elected HA over the shared metadata store")
    s.add_argument("--node-id", default=None,
                   help="this coordinator's latch identity (default: "
                        "hostname-derived)")
    s.add_argument("--lease-ms", type=int, default=15_000,
                   help="leader lease duration; failover bound")
    s.set_defaults(fn=cmd_coordinator)

    s = sub.add_parser("router", help="run the query router")
    s.add_argument("--port", type=int, default=8888)
    s.add_argument("--broker", action="append",
                   help="broker URL or tier=URL (repeatable)")
    s.set_defaults(fn=cmd_router)

    s = sub.add_parser("dump-segment", help="inspect an on-disk segment")
    s.add_argument("directory")
    s.add_argument("--full", action="store_true", help="load + column stats")
    s.add_argument("--rows", type=int, default=0, help="dump first N rows")
    _device_arg(s)
    s.set_defaults(fn=cmd_dump_segment)

    s = sub.add_parser("validate-segment", help="check an on-disk segment")
    s.add_argument("directory")
    s.set_defaults(fn=cmd_validate_segment)

    s = sub.add_parser("segment", help="segment storage tools")
    seg_sub = s.add_subparsers(dest="segment_command", required=True)
    si = seg_sub.add_parser(
        "inspect", help="per-column encoding/descriptor/size report")
    si.add_argument("directory")
    si.set_defaults(fn=cmd_segment_inspect)

    s = sub.add_parser("version")
    s.set_defaults(fn=lambda a: (print(VERSION), 0)[1])

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
