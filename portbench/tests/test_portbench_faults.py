"""A whole run of the harness on the CPU at a tiny scale, with the
program's timed path broken underneath, comes out not correct; the same
run unbroken comes out correct. The control (the reference in float32)
fails the cells' limits too.

The faults a served query can have: a step that returns its state
unchanged (a partial's merge keeps its first operand), part of the batch
left out (a data node's partials over half its segments), an answer
altered where it is produced (the lifecycle's rows), and, on a layout
whose data nodes shard over a mesh (4 cards, 2 nodes, a mesh of 2 CPU
shards each), the exchange between cards left out (the merge of the
shards' states keeps the first shard's part)."""
import json
import time

import pytest

from portbench import control, harness, registry

CELL = "tpch-sf50.timeseries"
#: 4 cards, 2 data nodes, each sharding over a mesh of 2
MESHED = {"chips": 4, "data_nodes": 2, "mesh": 2}


def _run(tiny, seconds=1.5, layout=None):
    bench = registry.benchmark()
    cell = registry.workload(bench, CELL)
    cfg = tiny(cell["config"])
    chips = cell["chips"]
    if layout is not None:
        cfg["layout"], chips = layout, layout["chips"]
    return harness.run_cell(CELL, cfg, registry.mix(cell["traffic"]),
                            2 ** 31 + 77, seconds, False, "cpu",
                            registry.metrics_of(bench, CELL, False),
                            cfg["limits"], time.time(), chips=chips)


def _alter(rows):
    """+1 on the first number of the first row's values."""
    rows = json.loads(json.dumps(rows))
    vals = rows[0].get("result", rows[0].get("event"))
    if isinstance(vals, list):
        vals = vals[0]
    for k, v in vals.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            vals[k] = v + 1
            break
    return rows


def _keep_first(self, a, b):
    return a


def _half_the_segments(orig):
    def run(segs, intervals, query, kds, vals, device, check=None):
        n = max(1, len(segs) // 2)
        return orig(segs[:n], intervals, query, kds[:n], vals[:n], device,
                    check)
    return run


def _first_shard_only(orig):
    def merge(kernels, per_shard, first):
        return orig(kernels, per_shard[:1], first)
    return merge


def _sound(r, chips):
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert r["device"]["count"] == chips
    # device_bytes_per_row is read off a card only
    assert set(r["metrics"]) == {"rows_per_s", "query_p50_ms", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in r["metrics"].values())


def test_sound_run_is_correct(tiny):
    from druid_tpu_torch.parallel.distributed import sharded_stats
    sharded = sharded_stats().snapshot()[0]
    _sound(_run(tiny, seconds=4.0), 1)
    assert sharded_stats().snapshot()[0] == sharded


def test_sound_run_on_a_meshed_layout_is_correct(tiny):
    """The layout's nodes shard TPC-H's full scans over their meshes."""
    from druid_tpu_torch.parallel.distributed import sharded_stats
    sharded = sharded_stats().snapshot()[0]
    _sound(_run(tiny, seconds=4.0, layout=MESHED), MESHED["chips"])
    assert sharded_stats().snapshot()[0] > sharded


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch",
                                   "answer_altered", "shard_left_out"])
def test_broken_path_is_not_correct(fault, tiny, monkeypatch):
    from druid_tpu_torch.engine import engines, kernels
    from druid_tpu_torch.parallel import distributed
    from druid_tpu_torch.server.lifecycle import QueryLifecycle
    layout = None
    if fault == "shard_left_out":
        monkeypatch.setattr(distributed, "_merge_shards",
                            _first_shard_only(distributed._merge_shards))
        layout = MESHED
    elif fault == "state_unchanged":
        monkeypatch.setattr(kernels.SumKernel, "combine", _keep_first)
        monkeypatch.setattr(kernels.CountKernel, "combine", _keep_first)
    elif fault == "half_the_batch":
        monkeypatch.setattr(engines, "_make_partials",
                            _half_the_segments(engines._make_partials))
    else:
        orig = QueryLifecycle.run
        monkeypatch.setattr(QueryLifecycle, "run",
                            lambda self, q, identity=None:
                            _alter(orig(self, q, identity)))
    r = _run(tiny, layout=layout)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  registry.benchmark()["workloads"]])
def test_control_fails_the_limits(cell, tiny):
    w = registry.workload(registry.benchmark(), cell)
    cfg = tiny(w["config"])
    nums = control.readings(cfg, registry.mix(w["traffic"]), 12345, "cpu")
    assert control.fails(nums, cfg["limits"]), nums
