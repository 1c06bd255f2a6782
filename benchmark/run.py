"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the compared numbers beside their limits as the last lines of
standard error, and one JSON object as the last line of standard output.
Needs as many CUDA cards as the cell asks for; exits non-zero without them,
and where a JAX module was loaded. See ``benchmark/README.md``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(1, str(Path(__file__).resolve().parents[1]))   # the port's package

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                         t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"modules that may not be loaded were loaded: {found}", file=sys.stderr)
        return 3
    print(f"window peak: {result['window_peak_bytes']} B", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
