"""The device trace's readings on made-up events: each card read apart,
busy time averaged over the layout's cards, kernel time summed over
them, and the events cut to the slice."""
import pytest

from portbench import devtrace, harness, registry

SLICE = (100.0, 110.0)


def _run(trace):
    records = [{"index": 0, "t_send": 100.0 + i, "t_done": 100.5 + i,
                "status": 200, "qid": f"q{i}"} for i in range(4)]
    spans = {"q0": [{"name": "engine/plan", "startMs": 102.0e3,
                     "durationMs": 2.0e3, "attrs": {}}]}
    return harness.RunData(
        cell="x", cfg={}, queries=[harness.Query("q", {}, 100, 800)],
        seconds=51.0, window=(90.0, 141.0), records=records, setup_s=1.0,
        held_rows=100, held_bytes=None, spans=spans, trace=trace,
        device_name="NVIDIA H100 80GB HBM3")


def _one_card():
    """The card busy over [101, 102] (a kernel) and [105, 106] (a copy),
    with a second kernel inside the first: 2 s busy of 10."""
    return devtrace.DeviceTrace(
        window=SLICE,
        kernels=[("void k1<int>", 101.0, 1.0, 0), ("k2", 101.5, 0.25, 0)],
        copies=[("Memcpy HtoD", 105.0, 1.0, 0)],
        host=[("engine/plan", 102.0, 2.0), ("aten::view", 100.0, 10.0)])


def test_one_card_reads_as_before():
    t = _one_card()
    assert t.busy_intervals(0) == [(101.0, 102.0), (105.0, 106.0)]
    assert t.busy_s == pytest.approx(2.0)
    assert t.kernel_s == pytest.approx(1.25)
    assert registry.reader("device_idle_pct").read(_run(t)) == \
        pytest.approx(80.0)
    # engine/plan spans [102, 104] of the idle 8 s
    assert registry.reader("idle_unspanned_pct").read(_run(t)) == \
        pytest.approx(100.0 * 6.0 / 8.0)
    assert registry.reader("kernel_ms_per_query").read(_run(t)) == \
        pytest.approx(1250.0 / 4)
    b = t.breakdown()
    assert b["device_ops"] == [["k1<int>", 1.0], ["Memcpy HtoD", 1.0],
                               ["k2", 0.25]]
    assert b["idle_gaps"] == [["engine/plan", 3.0]]


def test_two_cards_one_idle():
    """The same operations on card 0 and none on card 1: half the
    layout's card time is busy time of card 0's."""
    one = _one_card()
    busy = devtrace.DeviceTrace(window=SLICE, kernels=[
        ("k", 100.0, 10.0, 0)], cards=(0, 1))
    assert busy.busy_s == pytest.approx(5.0)
    assert registry.reader("device_idle_pct").read(_run(busy)) == \
        pytest.approx(50.0)
    two = devtrace.DeviceTrace(one.window, one.kernels, one.copies,
                               one.host, cards=(0, 1))
    assert two.busy_intervals(1) == []
    assert registry.reader("device_idle_pct").read(_run(two)) == \
        pytest.approx(90.0)
    # card 0 idle 8 s (2 spanned), card 1 idle 10 s (2 spanned)
    assert registry.reader("idle_unspanned_pct").read(_run(two)) == \
        pytest.approx(100.0 * (6.0 + 8.0) / 18.0)
    # the gaps lie between one card's operations, named by their card
    assert two.breakdown()["idle_gaps"] == [["card0 engine/plan", 3.0]]


def test_kernel_time_sums_over_cards():
    """Four cards each reading its quarter of the bytes at one card's
    peak rate, for the same second, read 100% of the roofline, not
    400%."""
    ops = [("k", 101.0, 1.0, c) for c in range(4)]
    t = devtrace.DeviceTrace(window=SLICE, kernels=ops, cards=(0, 1, 2, 3))
    assert t.kernel_s == pytest.approx(4.0)
    assert t.busy_s == pytest.approx(1.0)
    run = _run(t)
    run.queries[0].logical_bytes = int(4 * 3.35e12)  # 4 card-seconds
    run.records = run.records[:1]
    assert registry.reader("scan_roofline").read(run) == \
        pytest.approx(100.0)


def test_clip_keeps_the_slice():
    events = [("before", 90.0, 5.0, 0), ("across_start", 99.0, 2.0, 0),
              ("inside", 103.0, 1.0, 1), ("across_end", 109.5, 3.0, 0),
              ("after", 111.0, 1.0, 0), ("whole", 95.0, 20.0, 2)]
    assert devtrace.clip(events, SLICE) == [
        ("across_start", 100.0, 1.0, 0), ("inside", 103.0, 1.0, 1),
        ("across_end", 109.5, 0.5, 0), ("whole", 100.0, 10.0, 2)]
    host = [("aten::mm", 108.0, 4.0)]
    assert devtrace.clip(host, SLICE) == [("aten::mm", 108.0, 2.0)]


@pytest.mark.parametrize("layout,chips,message", [
    ({"chips": 4}, 1, "asks for 4 cards"),
    ({"chips": 4, "mesh": 3}, 4, "not a multiple"),
    ({"chips": 0}, 1, "1 or more"),
])
def test_layout_that_cannot_be_built(layout, chips, message):
    with pytest.raises(ValueError, match=message):
        harness.Layout.of({"name": "x", "layout": layout}, chips)


def test_layout_places_nodes_and_meshes():
    lay = harness.Layout.of({"layout": {"chips": 4, "data_nodes": 2,
                                        "mesh": 2}}, 4)
    assert [lay.node_cards(i) for i in range(2)] == [[0, 1], [2, 3]]
    # nodes may share cards: two nodes, each over all four
    lay = harness.Layout.of({"layout": {"chips": 4, "mesh": 4}}, 4)
    assert [lay.node_cards(i) for i in range(2)] == [[0, 1, 2, 3]] * 2
    # no mesh: node i on card i mod chips; the defaults are one card, two
    # nodes
    lay = harness.Layout.of({"layout": {"chips": 2, "data_nodes": 3}}, 2)
    assert [lay.node_cards(i) for i in range(3)] == [[0], [1], [0]]
    assert harness.Layout.of({}) == harness.Layout(1, 2, 0)
    placed = harness.placement(harness.Layout(4, 2, 2), "cpu")
    assert [(str(d), m.size) for d, m in placed] == [("cpu", 2)] * 2
