"""The readings the limits of ``checks/<workload>.json`` are set from.

    python benchmark/readings.py --workload <name> --seeds 1,2,3 [--what program,control,half_batch]

For each seed, in one process: ``program`` the port's sound first calls
against the float32 reference; ``control`` the reference in the precision
below the configuration's (``reference.Precision("fp8")``) in the port's
place; ``half_batch`` the port with half of each batch left out;
``bfloat16`` (asked for by name) the reference in bfloat16, a witness of
what the configurations' rounding alone reads. One JSON line per seed and
kind, with the numbers compared. Needs a CUDA card
unless ``--device cpu`` (with ``--sizes`` for a small run).
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(1, str(Path(__file__).resolve().parents[1]))   # the port's package

import torch  # noqa: E402

from portbench import check, harness  # noqa: E402
from portbench.reference import Precision  # noqa: E402

KINDS = ("program", "control", "half_batch")


def seed_readings(cell, seed: int, what, device, sizes=None, dtype=torch.bfloat16,
                  look: bool = False):
    """-> {kind: the numbers compared} for one seed; with ``look``, also
    ``check.detail`` of each."""
    n = int(cell.traffic["check_calls"])
    out = {}
    ref = None

    def reference():
        nonlocal ref
        if ref is None:
            if device.type == "cuda":
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
            ref = harness.make_runner(cell, seed, device, sizes=sizes).reference(
                Precision("float32"), n)
        return ref

    for kind in what:
        if kind in ("control", "bfloat16"):
            prec = Precision("fp8" if kind == "control" else kind)
            other = harness.make_runner(cell, seed, device, sizes=sizes).reference(prec, n)
            out[kind] = _numbers(other, reference(), look)
            continue
        d = harness.make_runner(cell, seed, device, dtype=dtype, sizes=sizes,
                                fault=None if kind == "program" else kind)
        d.build()
        prog = d.first_calls(n)
        d.free()
        if device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        out[kind] = _numbers(prog, reference(), look)
        torch.backends.cudnn.allow_tf32 = True
    return out


def _numbers(prog, ref, look: bool) -> dict:
    numbers = check.gaps(prog, ref)
    if look:
        numbers["detail"] = check.detail(prog, ref)
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--what", default=",".join(KINDS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", default=None, help="JSON of size overrides (small CPU runs)")
    ap.add_argument("--look", action="store_true",
                    help="also print the worst leaves, the median leaf's gap and the losses")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    sizes = json.loads(args.sizes) if args.sizes else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        for kind, numbers in seed_readings(cell, seed, args.what.split(","), device,
                                           sizes, look=args.look).items():
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                              **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
