"""Staging: the `pool/h2d` spans (device-pool builds) of the window's
queries, per query answered. 0 while nothing is evicted and staged
again."""
from portbench.metrics import _spans


def read(run):
    done = run.completed()
    if not done or not run.spans:
        return None
    return sum(_spans.total(run.spans.get(r["qid"], ()), "pool/h2d") or 0.0
               for r in done) / len(done)
