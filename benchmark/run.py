"""Run one cell of the benchmark on the CUDA card(s) of this machine.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics with --trace 0, its per-layer metrics with --trace 1), device and,
traced, breakdown; the numbers the correctness check compared, each beside
its limit, come last there and as the last lines of standard error. Exits
non-zero, printing no result, without enough CUDA cards, or when JAX or the
JAX package has been loaded.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _cache_dirs() -> None:
    """Kernel caches at fixed paths inside the checkout (the program's flash
    kernels build into its own ``_build/`` there)."""
    cache = ROOT / ".bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    _cache_dirs()
    import torch

    from benchmark import harness

    spec = harness.load_spec(ROOT)
    cell = harness.resolve_cell(spec, args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found {found}",
              file=sys.stderr)
        return 2
    readers = harness.readers_of(cell, ROOT) if args.trace else None
    out = cell.driver.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"loaded in the benchmark's process: {', '.join(loaded)}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips}
    line = harness.result_line(cell, out, bool(args.trace), device, readers)
    for name, check in line["check"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
