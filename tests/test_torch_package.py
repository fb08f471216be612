"""The port stands alone: no jax, no druid_tpu, no silent CPU fallback."""
import ast
import ctypes
import os
import re
import subprocess
import threading
import sys
from pathlib import Path

import pytest
import torch

from druid_tpu_torch import _build, device
from druid_tpu_torch.engine import QueryExecutor
from druid_tpu_torch.engine import kernels as K
from druid_tpu_torch.engine import megakernel as mk
from druid_tpu_torch.engine import sorted_reduce as sr
from druid_tpu_torch.query import aggregators as A

# One intra-op thread: these tensors are small, and an OpenMP pool in every
# test worker would compete for cores with the suite's timing tests.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def test_import_pulls_in_neither_jax_nor_druid_tpu():
    """Importing every module of the port, the serving path's cluster/,
    server/ and obs/ among them (the HTTP data node, the wire, the query
    resource, the scheduler, security and /metrics), the SQL layer with
    Avatica and the router, and segment storage (storage/, the host codec's
    native/, data/bitmap.py, the load queue and the chaos harness), and
    ingestion (ingest/, the MetadataStore, the realtime server, standing
    queries, the subscription hub and the protobuf parser), and the mesh
    (parallel/: the context, the layout, the sharded run), loads neither
    jax nor druid_tpu, druid_tpu.native included; nor does `import
    druid_tpu_torch.ext` load google.protobuf (the parser imports it when
    it is built)."""
    code = ("import sys, druid_tpu_torch, druid_tpu_torch.engine, "
            "druid_tpu_torch.data.generator, druid_tpu_torch.data.convert, "
            "druid_tpu_torch.data.packed, druid_tpu_torch.data.cascade, "
            "druid_tpu_torch.utils.expression, druid_tpu_torch.query.lookup, "
            "druid_tpu_torch.engine.hll, druid_tpu_torch.engine.executor, "
            "druid_tpu_torch.query.model, druid_tpu_torch.engine.filters, "
            "druid_tpu_torch.engine.engines, druid_tpu_torch.data.segment, "
            "druid_tpu_torch.ext, druid_tpu_torch.cluster, "
            "druid_tpu_torch.cluster.broker, druid_tpu_torch.cluster.view, "
            "druid_tpu_torch.cluster.cache, druid_tpu_torch.cluster.metadata, "
            "druid_tpu_torch.cluster.resilience, "
            "druid_tpu_torch.cluster.timeline, "
            "druid_tpu_torch.cluster.shardspec, druid_tpu_torch.server, "
            "druid_tpu_torch.server.deadline, "
            "druid_tpu_torch.server.querymanager, druid_tpu_torch.obs, "
            "druid_tpu_torch.obs.trace, druid_tpu_torch.obs.dispatch, "
            "druid_tpu_torch.utils.emitter, druid_tpu_torch.cluster.wire, "
            "druid_tpu_torch.cluster.dataserver, "
            "druid_tpu_torch.server.http, druid_tpu_torch.server.lifecycle, "
            "druid_tpu_torch.server.scheduler, "
            "druid_tpu_torch.server.security, druid_tpu_torch.obs.catalog, "
            "druid_tpu_torch.obs.prometheus, druid_tpu_torch.sql, "
            "druid_tpu_torch.sql.planner, druid_tpu_torch.server.avatica, "
            "druid_tpu_torch.server.router, druid_tpu_torch.storage, "
            "druid_tpu_torch.storage.codec, druid_tpu_torch.storage.smoosh, "
            "druid_tpu_torch.storage.format, "
            "druid_tpu_torch.storage.format_v2, "
            "druid_tpu_torch.storage.plan, druid_tpu_torch.storage.deep, "
            "druid_tpu_torch.native, druid_tpu_torch.native.lz4block, "
            "druid_tpu_torch.data.bitmap, druid_tpu_torch.cluster.loadqueue, "
            "druid_tpu_torch.cluster.chaos, druid_tpu_torch.ingest, "
            "druid_tpu_torch.ingest.input, druid_tpu_torch.ingest.incremental, "
            "druid_tpu_torch.ingest.merger, "
            "druid_tpu_torch.ingest.appenderator, "
            "druid_tpu_torch.ingest.receiver, "
            "druid_tpu_torch.ingest.streaming, "
            "druid_tpu_torch.cluster.realtime, "
            "druid_tpu_torch.engine.standing, "
            "druid_tpu_torch.server.subscriptions, "
            "druid_tpu_torch.ext.protobuf_parser, "
            "druid_tpu_torch.parallel, druid_tpu_torch.parallel.context, "
            "druid_tpu_torch.parallel.speclayout, "
            "druid_tpu_torch.parallel.distributed; "
            "from druid_tpu_torch.native import lz4block; "
            "lz4block.compress(b'abcd' * 64); "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'druid_tpu' "
            "or m.startswith('druid_tpu.') or m == 'google.protobuf' "
            "or m.startswith('google.protobuf.')); print(bad)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix()
     for p in (ROOT / "druid_tpu_torch").rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_source_imports_jax_or_druid_tpu(path):
    bad = [m for m in _imports(ROOT / path)
           if m.split(".")[0] in ("jax", "jaxlib", "druid_tpu")]
    assert bad == []


def _environment_reads(path: Path):
    """os.environ / os.getenv / os.putenv uses in one source file."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Attribute) and node.attr in (
                "environ", "getenv", "putenv", "environb"):
            yield f"{path.name}:{node.lineno} {node.attr}"
        elif isinstance(node, ast.ImportFrom) and node.module == "os" \
                and any(a.name in ("environ", "getenv") for a in node.names):
            yield f"{path.name}:{node.lineno} from os import"


def test_port_reads_no_environment_variable():
    """The port reads no environment flag (the reference's DRUID_TPU_*
    switches are module functions here: standing.set_enabled,
    packed.set_enabled, ...); no source under druid_tpu_torch/ touches
    os.environ or os.getenv."""
    found = [r for p in sorted((ROOT / "druid_tpu_torch").rglob("*.py"))
             for r in _environment_reads(p)]
    assert found == []


def test_executor_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        QueryExecutor()
    with pytest.raises(RuntimeError, match="CUDA"):
        device.resolve("cuda")
    assert device.resolve("cpu").type == "cpu"


def test_every_query_type_needs_cuda_without_a_device(monkeypatch):
    """No entry point falls back to the CPU: an executor asked for the
    default device without a card raises before any query runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for q in ({"queryType": "scan", "dataSource": "x"},
              {"queryType": "timeBoundary", "dataSource": "x"},
              {"queryType": "segmentMetadata", "dataSource": "x"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            QueryExecutor().run_json(q)


def test_cuda_wrapper_refuses_cpu_tensors_without_building(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("kernel build attempted on the CPU")
    monkeypatch.setattr(_build, "build_all", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    kernels = [K.CountKernel(A.CountAggregator("rows"))]
    key = torch.zeros(4096, dtype=torch.int32)
    mask = torch.ones(4096, dtype=torch.bool)
    before = sr.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        sr.sorted_reduce_cuda({}, mask, key, kernels, 256, 1)
    counts, _ = sr.sorted_reduce({}, mask, key, kernels, 256, 1)
    assert int(counts[0]) == 4096 and sr.LAUNCHES == before


def test_b2_wrapper_refuses_cpu_tensors_without_building(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("kernel build attempted on the CPU")
    monkeypatch.setattr(_build, "build_all", no_build)
    monkeypatch.setattr(_build, "load", no_build)
    kernels = [K.CountKernel(A.CountAggregator("rows"))]
    key = torch.zeros(4100, dtype=torch.int32)
    words = torch.full((129,), -1, dtype=torch.int32)
    before = (sr.LAUNCHES, mk.LAUNCHES, mk.PLAIN_CALLS)
    with pytest.raises(ValueError, match="CUDA"):
        mk.mega_reduce_cuda({}, words, key, kernels, 256, 1)
    counts, _ = mk.mega_reduce({}, torch.ones(4100, dtype=torch.bool), key,
                               [], kernels, 256, 1)
    assert int(counts[0]) == 4100
    assert (sr.LAUNCHES, mk.LAUNCHES, mk.PLAIN_CALLS) \
        == (before[0], before[1], before[2] + 1)


def test_wrapper_rejects_plans_outside_the_caps():
    kernels = [K.CountKernel(A.CountAggregator("rows"))]
    key = torch.zeros(64, dtype=torch.int32)
    mask = torch.ones(64, dtype=torch.bool)
    with pytest.raises(ValueError, match="caps"):
        sr.sorted_reduce({}, mask, key, kernels, sr.MAX_PALLAS_GROUPS * 2, 1)
    with pytest.raises(ValueError, match="caps"):
        sr.sorted_reduce({}, mask, key, kernels, 256, sr.MAX_W + 1)


def test_build_targets_sm90a_from_repo_sources():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert (_build.CSRC / "sorted_reduce.cu").exists()
    assert _build.BUILD_DIR.relative_to(ROOT).parts[0] == "build"
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_params_struct_matches_cuda_layout():
    """The ctypes mirror of SrParams: 4 pointers, an int64, seven ints, two
    arrays of 17 ints, 8 field pointers, two arrays of 17 pointers, the
    mask-words pointer, and the packed fields' widths and bases (8 ints
    each) at the end (natural alignment)."""
    off = {name: getattr(sr._Params, name).offset
           for name, _ in sr._Params._fields_}
    assert off["n"] == 32 and off["kind"] == 68
    assert off["field"] == 68 + 17 * 4
    assert off["fsrc"] == 136 + 17 * 4 + 4
    assert off["part"] == off["fsrc"] + 8 * 8
    assert off["mask_words"] == off["out"] + 17 * 8
    assert off["fwidth"] == off["mask_words"] + 8
    assert off["fbase"] == off["fwidth"] + 8 * 4
    assert ctypes.sizeof(sr._Params) == off["fbase"] + 8 * 4


def test_params_struct_fields_in_source_order():
    """The ctypes field names follow SrParams's members in the CUDA source,
    in order: a member added to one side only would shift the rest."""
    src = (_build.CSRC / "sorted_reduce.cu").read_text()
    body = src[src.index("struct SrParams {"):].split("};")[0]
    members = re.findall(r"(\w+)(?:\[\w+\])?;", body)
    assert members == [name for name, _ in sr._Params._fields_]


def test_serving_entry_points_need_cuda_without_a_device(monkeypatch):
    """The serving path's entry points resolve their device as the
    executor does: the default is CUDA, and without a card they raise."""
    from druid_tpu_torch.cluster import Broker, DataNode, InventoryView
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        DataNode("n0")
    with pytest.raises(RuntimeError, match="CUDA"):
        Broker(InventoryView())
    assert DataNode("n0", device="cpu").device.type == "cpu"
    assert Broker(InventoryView(), device="cpu").device.type == "cpu"


def test_ingestion_entry_points_need_cuda_without_a_device(monkeypatch):
    """The realtime server, a standing query and the subscription hub run
    their folds on CUDA unless the caller passes device="cpu"."""
    from druid_tpu_torch.cluster import InventoryView, RealtimeServer
    from druid_tpu_torch.engine.standing import StandingQuery
    from druid_tpu_torch.query.model import query_from_json
    from druid_tpu_torch.server.subscriptions import SubscriptionHub
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = query_from_json({"queryType": "timeseries", "dataSource": "rt",
                         "intervals": ["2026-03-01/2026-03-02"],
                         "granularity": "all",
                         "aggregations": [{"type": "count", "name": "n"}]})
    with pytest.raises(RuntimeError, match="CUDA"):
        RealtimeServer("rt0", InventoryView())
    with pytest.raises(RuntimeError, match="CUDA"):
        StandingQuery(q)
    with pytest.raises(RuntimeError, match="CUDA"):
        SubscriptionHub()
    assert RealtimeServer("rt1", InventoryView(),
                          device="cpu").device.type == "cpu"
    sq = StandingQuery(q, device="cpu")
    assert sq.device.type == "cpu"
    sq.close()
    hub = SubscriptionHub(device="cpu")
    assert hub.device.type == "cpu"
    hub.stop()


def test_launch_counters_are_guarded():
    """The kernels' counts are bumped under a lock (the broker's scatter
    threads launch concurrently): 8 threads x 50 calls of the plain route
    count 400."""
    kernels = [K.CountKernel(A.CountAggregator("rows"))]
    key = torch.zeros(64, dtype=torch.int32)
    mask = torch.ones(64, dtype=torch.bool)
    before = sr.PLAIN_CALLS

    def work():
        for _ in range(50):
            sr.sorted_reduce({}, mask, key, kernels, 256, 1)
    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sr.PLAIN_CALLS - before == 400
    assert isinstance(sr.COUNT_LOCK, type(threading.Lock()))
    assert isinstance(mk.COUNT_LOCK, type(threading.Lock()))
