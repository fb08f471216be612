"""The readers of the program's stage spans on a made-up window:
`plan_ms`, `partials_cpu_ms`, `reply_ms` and `idle_unspanned_pct`, and
each one's empty reading (None) where the program has no such span or the
run no device trace."""
import pytest

from portbench import devtrace, harness, registry


def _span(name, ms, cpu=None):
    attrs = {} if cpu is None else {"cpuMs": cpu}
    return {"name": name, "durationMs": ms, "attrs": attrs}


RECORDS = [{"index": 0, "t_send": float(i), "t_done": i + 0.5,
            "status": 200, "qid": f"q{i}"} for i in range(3)]

#: per query: two nodes' plans, partials and one reply
SPANS = {
    "q0": [_span("engine/plan", 1.0), _span("engine/plan", 2.0),
           _span("engine/partials", 10.0, cpu=4.0),
           _span("engine/partials", 12.0, cpu=5.0),
           _span("http/reply", 0.5)],
    "q1": [_span("engine/plan", 5.0), _span("engine/partials", 30.0,
                                            cpu=20.0),
           _span("http/reply", 0.25)],
    "q2": [_span("engine/plan", 2.0), _span("engine/plan", 2.0),
           _span("engine/partials", 8.0, cpu=1.0),
           _span("http/reply", 2.0)],
}


def _run(spans=None, trace=None, window=(0.0, 10.0)):
    return harness.RunData(
        cell="x", cfg={}, queries=[harness.Query("q", {}, 100, 800)],
        seconds=window[1] - window[0], window=window, records=RECORDS,
        setup_s=1.0, held_rows=100, held_bytes=None, spans=spans or {},
        trace=trace)


@pytest.mark.parametrize("metric,want", [
    ("plan_ms", 4.0),             # medians of 3.0, 5.0, 4.0
    ("partials_cpu_ms", 9.0),     # of 9.0, 20.0, 1.0
    ("reply_ms", 0.5),            # of 0.5, 0.25, 2.0
])
def test_span_readers(metric, want):
    assert registry.reader(metric).read(_run(SPANS)) == pytest.approx(want)


#: what a program without the stage spans leaves: the broker's spans and
#: `engine/partials` without `cpuMs`
PARENT = {q: [_span("broker/query", 40.0), _span("engine/partials", 10.0)]
          for q in SPANS}


@pytest.mark.parametrize("metric", ["plan_ms", "partials_cpu_ms",
                                    "reply_ms"])
@pytest.mark.parametrize("spans", [None, PARENT], ids=["untraced",
                                                        "parent"])
def test_span_readers_read_nothing(metric, spans):
    assert registry.reader(metric).read(_run(spans)) is None


def _trace(start=100.0):
    """A 10 s slice: the card busy over [1, 2] and [5, 6] (a kernel and a
    copy), idle over [0, 1], [2, 5] and [6, 10]: 8 s. The host's ranges
    name no span: the reader takes the spans from the store."""
    return devtrace.DeviceTrace(
        window=(start, start + 10.0),
        kernels=[("k", 101.0, 1.0, 0)],
        copies=[("Memcpy HtoD", 105.0, 1.0, 0)],
        host=[("aten::view", 100.0, 10.0)])


def _timed(name, start_s, dur_s):
    return {"name": name, "startMs": start_s * 1e3,
            "durationMs": dur_s * 1e3, "attrs": {}}


@pytest.mark.parametrize("spans,want", [
    # engine/plan over [2, 4] and broker/query over [3, 5.5], of two
    # queries: 3 s of the idle 8 s spanned (0.5 s of broker/query lies in
    # busy time)
    ({"q0": [_timed("engine/plan", 102.0, 2.0)],
      "q1": [_timed("broker/query", 103.0, 2.5)]}, 100.0 * 5.0 / 8.0),
    # a query in flight when the slice began, over all of it, and a span
    # after it
    ({"q0": [_timed("query", 99.0, 12.0)],
      "q1": [_timed("http/reply", 120.0, 1.0)]}, 0.0),
    # a span begun before the slice that ends in its first idle second
    ({"q0": [_timed("http/request", 95.0, 5.5)]}, 100.0 * 7.5 / 8.0),
    # spans only inside busy time: none of the idle time is spanned
    ({"q0": [_timed("engine/reduce", 101.2, 0.5),
             _timed("pool/h2d", 105.0, 1.0)]}, 100.0),
])
def test_idle_unspanned_pct(spans, want):
    got = registry.reader("idle_unspanned_pct").read(
        _run(spans, trace=_trace(), window=(90.0, 141.0)))
    assert got == pytest.approx(want)


def test_idle_unspanned_pct_reads_the_slice_inside_the_window():
    """A slice begun late runs past the window's close (at 108): its idle
    [108, 110] is left out, and so is all of a slice after the window."""
    spans = {"q0": [_timed("query", 99.0, 9.0)]}
    reader = registry.reader("idle_unspanned_pct")
    assert reader.read(_run(spans, trace=_trace(),
                            window=(57.0, 108.0))) == pytest.approx(0.0)
    assert reader.read(_run(spans, trace=_trace(),
                            window=(102.5, 153.5))) == pytest.approx(
        100.0 * 2.0 / 6.5)          # idle [102.5, 105] and [106, 110]
    assert reader.read(_run(spans, trace=_trace(200.0),
                            window=(57.0, 108.0))) is None


@pytest.mark.parametrize("spans,trace", [
    (None, None),                            # an untraced run
    ({"q0": [_timed("query", 99.0, 12.0)]}, None),   # no device trace
    (None, _trace()),                        # no span stored
    (PARENT, _trace()),                      # spans without a start
], ids=["untraced", "no-trace", "no-spans", "no-start"])
def test_idle_unspanned_pct_reads_nothing(spans, trace):
    assert registry.reader("idle_unspanned_pct").read(
        _run(spans, trace=trace, window=(90.0, 141.0))) is None


def test_idle_unspanned_pct_lists_the_programs_spans():
    """The reader's list is the port's list of spans."""
    from druid_tpu_torch.obs import trace as qtrace
    doc = qtrace.__doc__
    for name in registry.reader("idle_unspanned_pct").SPANS:
        assert name in doc, name


@pytest.mark.chip
def test_span_ranges_stay_on_the_host(cuda):
    """On the card a span's profiler range is a host event only: no
    device-side event of its name joins the kernels, whose union
    `device_idle_pct` and the idle gaps read as the card's busy time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from druid_tpu_torch.obs import trace as qtrace
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with qtrace.root_span("query", store=qtrace.TraceStore()):
            with qtrace.span("engine/reduce"):
                torch.ones(1 << 20, device=cuda).cumsum(0)
            torch.cuda.synchronize(cuda)
    events = [(e.name(), e.device_type())
              for e in prof.profiler.kineto_results.events()]
    assert ("engine/reduce", DeviceType.CPU) in events
    assert any(d == DeviceType.CUDA for _, d in events)
    assert not [n for n, d in events
                if d == DeviceType.CUDA and n in ("query", "engine/reduce")]
