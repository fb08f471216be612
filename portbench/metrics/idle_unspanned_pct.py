"""Device: the share of the traced slice's idle time during which no span
of the port was open: the idle time no span explains. A card's idle time
is the slice less its busy intervals; the unspanned idle time is summed
over the layout's cards and divided by the idle time summed over them.
The spans are the stored ones of the window's queries (`startMs` on the
wall clock the profiler stamps its events on), so a query already in
flight when the slice begins counts from its own start; the device trace
gives only the busy intervals. Only the slice's part inside the window
counts."""
from portbench.devtrace import union

#: the port's spans (PERF.md's table of spans and counters)
SPANS = frozenset({
    "http/request", "http/reply", "query", "queue/wait", "sched/flush",
    "broker/query", "broker/plan", "broker/scatter", "broker/node",
    "broker/merge", "datanode/query", "engine/partials", "engine/plan",
    "engine/stage", "engine/reduce", "engine/to_host", "pool/h2d"})


def idle(window, busy):
    """The window less the sorted disjoint `busy` intervals."""
    lo, hi = window
    out, t = [], lo
    for a, b in busy:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out


def overlap(xs, ys):
    """Total length of the intersection of two sorted disjoint lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(run):
    t = run.trace
    if t is None:
        return None
    spanned = union((s["startMs"] / 1e3,
                     (s["startMs"] + s["durationMs"]) / 1e3)
                    for spans in run.spans.values() for s in spans
                    if s.get("name") in SPANS
                    and s.get("startMs") is not None
                    and s.get("durationMs") is not None)
    if not spanned:
        return None
    lo, hi = max(t.window[0], run.window[0]), min(t.window[1], run.window[1])
    if hi <= lo:
        return None
    idle_s = unspanned_s = 0.0
    for card in t.cards:
        gaps = idle((lo, hi), t.busy_intervals(card))
        card_idle = sum(b - a for a, b in gaps)
        idle_s += card_idle
        unspanned_s += card_idle - overlap(gaps, spanned)
    if idle_s <= 0:
        return 0.0
    return 100.0 * unspanned_s / idle_s
