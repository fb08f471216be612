"""Engine: the CPU time (`cpuMs`, the thread's `time.thread_time()`) of
each query's `engine/partials` spans summed over both data nodes; median
over the window's queries. Against `partials_ms`, the rest is the time
the thread did not run: the interpreter lock, a lock, a blocking wait
(a CUDA sync that spins counts as CPU time)."""
from portbench.harness import median


def cpu_total(spans, name):
    xs = [s["attrs"]["cpuMs"] for s in spans
          if s.get("name") == name
          and (s.get("attrs") or {}).get("cpuMs") is not None]
    return sum(xs) if xs else None


def read(run):
    out = [cpu_total(run.spans.get(r["qid"], ()), "engine/partials")
           for r in run.completed()]
    return median([x for x in out if x is not None])
