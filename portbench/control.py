"""The control of `correct`: the plain reference put in the program's
place, its sums accumulated in float32, the step below what the
configurations state (int64 LONG sums, float64 DOUBLE sums). Each
query's control answer is held against the exact reference's with the
harness's own comparison, and the numbers are printed beside the cell's
limits: a control that passes every limit means the limits cannot tell a
lower precision from a sound run.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3

Runs on the CUDA card at the cell's own size (the tests call `readings`
on the CPU at a tiny scale). Imports nothing of the port.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cfg: dict, mix: dict, seed: int, device) -> dict:
    """The control's numbers for one seed, as the harness names them."""
    from portbench import reference
    queries = [q["query"] for q in mix["queries"]]
    exact = reference.answers(cfg, queries, seed, device)
    low = reference.answers(cfg, queries, seed, device, precision="float32")
    verdict, wrong = reference.Verdict(), 0
    for got, want in zip(low, exact):
        v = reference.compare(got, want)
        wrong += int(v.keys_wrong + v.exact_wrong > 0)
        verdict.merge(v)
    return {"answers_wrong": wrong, "rel_err_max": verdict.rel_err}


def fails(numbers: dict, limits: dict) -> bool:
    return numbers["answers_wrong"] > 0 or \
        numbers["rel_err_max"] > limits["rel_err_max"]


def main(argv=None) -> int:
    import torch
    from portbench import registry
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cell = registry.workload(registry.benchmark(), args.workload)
    cfg = registry.config(cell["config"])
    mix = registry.mix(cell["traffic"])
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    all_fail = True
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        nums = readings(cfg, mix, seed, device)
        failed = fails(nums, cfg["limits"])
        all_fail &= failed
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": nums, "limits": cfg["limits"],
                          "control_fails": failed,
                          "seconds": time.time() - t}), flush=True)
    return 0 if all_fail else 1


if __name__ == "__main__":
    sys.exit(main())
