"""The benchmark's entry.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of `BENCHMARK.json` on the CUDA cards its configuration's
`layout` places it on (`harness.py`) and prints, as its last line of
standard output, one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), `device`, with `--trace 1` `breakdown`, and last
`checks`, each number compared with its limit. Set-up, the window's
counts and the checks go to standard error. Exits 2 without a result
where fewer cards than the cell's `chips` are found, 3 where JAX or the
JAX package was loaded, and 1 where the layout cannot be built.
"""
from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness, registry
    bench = registry.benchmark()
    cell = registry.workload(bench, args.workload)

    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        harness.log(f"needs {cell['chips']} CUDA card(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    cfg = registry.config(cell["config"])
    mix = registry.mix(cell["traffic"])
    result = harness.run_cell(
        cell["name"], cfg, mix, args.seed, args.seconds, bool(args.trace),
        "cuda", registry.metrics_of(bench, cell["name"], bool(args.trace)),
        cfg["limits"], T0, chips=int(cell["chips"]))

    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"loaded in this process: {', '.join(bad)}")
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
