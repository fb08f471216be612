"""The readers of the end-to-end metrics on a made-up window, and the
clients' shared order."""
import threading

import pytest

from portbench import clients, harness, registry


def _run(records, seconds=10.0):
    qs = [harness.Query("small", {}, 100, 800),
          harness.Query("big", {}, 1000, 8000)]
    return harness.RunData(cell="x", cfg={}, queries=qs, seconds=seconds,
                           window=(0.0, seconds), records=records,
                           setup_s=1.0, held_rows=1100, held_bytes=None)


def _rec(index, t_send, t_done, status=200):
    return {"index": index, "t_send": t_send, "t_done": t_done,
            "status": status, "qid": f"q{t_send}"}


RECORDS = [_rec(0, 0.0, 1.0), _rec(1, 0.0, 4.0), _rec(0, 1.0, 2.0),
           _rec(1, 4.0, 8.0), _rec(0, 2.0, 3.0, status=500),
           _rec(1, 8.0, 12.0), _rec(0, 3.0, None, status=None)]


def test_rows_per_s_credits_the_share_inside_the_window():
    run = _run(RECORDS)
    # 100 + 1000 + 100 + 1000 answered inside; the big query in flight
    # at the close counts half (2 s of its 4 inside); the 500 counts 0
    got = registry.reader("rows_per_s").read(run)
    assert got == pytest.approx((100 + 1000 + 100 + 1000 + 500) / 10.0)


def test_latencies_wait_for_the_queries_in_flight():
    run = _run(RECORDS)
    assert sorted(run.latencies_ms()) == [1000.0, 1000.0, 4000.0, 4000.0,
                                          4000.0]
    assert registry.reader("query_p50_ms").read(run) == 4000.0
    # the failed query counts as infinite in the tail
    assert registry.reader("query_p90_ms").read(run) == float("inf")


def test_percentile_is_nearest_rank():
    xs = list(range(1, 101))
    assert harness.percentile(xs, 90) == 90
    assert harness.percentile(xs, 50) == 50


def test_the_clients_share_one_order():
    q = clients.Queue(9)
    got, lock = [], threading.Lock()

    def take():
        for _ in range(90):
            k = q.next()
            with lock:
                got.append(k)
    ts = [threading.Thread(target=take) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert sorted(got) == sorted(list(range(9)) * 40)
