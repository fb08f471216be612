"""A whole run of the harness on the CPU at a tiny scale, with the
program's timed path broken underneath, comes out not correct; the same
run unbroken comes out correct. The control (the reference in float32)
fails the cells' limits too.

The faults a served query can have: a step that returns its state
unchanged (a partial's merge keeps its first operand), part of the batch
left out (a data node's partials over half its segments), and an answer
altered where it is produced (the lifecycle's rows). One card, so no
exchange between chips to leave out."""
import json
import time

import pytest

from portbench import control, harness, registry

CELL = "tpch-sf50.timeseries"


def _run(tiny, seconds=1.5):
    bench = registry.benchmark()
    cell = registry.workload(bench, CELL)
    cfg = tiny(cell["config"])
    return harness.run_cell(CELL, cfg, registry.mix(cell["traffic"]),
                            2 ** 31 + 77, seconds, False, "cpu",
                            registry.metrics_of(bench, CELL, False),
                            cfg["limits"], time.time())


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


def test_sound_run_is_correct(tiny):
    r = _run(tiny, seconds=4.0)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    # device_bytes_per_row is read off a card only
    assert set(r["metrics"]) == {"rows_per_s", "query_p50_ms", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in r["metrics"].values())


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch",
                                   "answer_altered"])
def test_broken_path_is_not_correct(fault, tiny, monkeypatch):
    from druid_tpu_torch.engine import engines, kernels
    from druid_tpu_torch.server.lifecycle import QueryLifecycle
    if fault == "state_unchanged":
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
    r = _run(tiny)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  registry.benchmark()["workloads"]])
def test_control_fails_the_limits(cell, tiny):
    w = registry.workload(registry.benchmark(), cell)
    cfg = tiny(w["config"])
    nums = control.readings(cfg, registry.mix(w["traffic"]), 12345, "cpu")
    assert control.fails(nums, cfg["limits"]), nums
