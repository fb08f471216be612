"""Peon process entry point: `python -m druid_tpu_torch.peon <task-spec.json>`.

Reference analog: CliPeon (services/src/main/java/org/apache/druid/cli/
CliPeon.java) — the forked child that runs exactly one task, doing its
lock/publish metadata actions against the overlord's action endpoint and
writing segment bytes straight to shared deep storage. Its work is host
work: it runs on the CPU, creates no CUDA context, and says so with its
status (indexing/forking.py).
"""
import sys

from druid_tpu_torch.indexing.forking import peon_main

if __name__ == "__main__":
    if len(sys.argv) != 2:
        print("usage: python -m druid_tpu_torch.peon <task-spec.json>",
              file=sys.stderr)
        sys.exit(2)
    sys.exit(peon_main(sys.argv[1]))
