"""The control of a cell's correctness check, and the program's own
readings, on the card (not run by the benchmark's runs):

    python3 benchmark/control.py --workload <name> --seeds 1 2 3 [--control none|...] [--batches 3]

prints one JSON line per seed with the numbers the check compares for the
first --batches batches of a run with that seed: the program as the cell
runs it (--control none), or a control the cell's driver names (the sample
driver: "int8", the program with its int8 path switched on, and "fp8", the
reference computed in float8 in the program's place, each the precision
below the bf16 the configuration states; "guidance" and "stale", the program
with a fault of the sampler's later passes planted). Each limit sits between
the program's largest reading over a dozen seeds and the controls' smallest.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", default="none")
    ap.add_argument("--batches", type=int, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    cell = harness.resolve_cell(harness.load_spec(ROOT), args.workload, ROOT)
    batches = args.batches or int(cell.traffic.get("check_batches", 1))
    for seed in args.seeds:
        t0 = time.perf_counter()
        values = cell.driver.readings(cell, seed, batches, args.control)
        print(json.dumps({"workload": args.workload, "control": args.control, "seed": seed,
                          "batches": batches, **values,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
