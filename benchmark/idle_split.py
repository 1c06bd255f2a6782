"""One cell's traced run with its idle split into host waits, queued
bubbles and gaps inside one CUDA graph launch, on a machine with an NVIDIA
card:

    python3 benchmark/idle_split.py --workload <name> --seed <n> --seconds <s>

Runs as ``run.py --trace 1`` does, with the traced window read by
``portbench/spans.py`` in place of ``trace.read_profile``: the result
line's ``breakdown.idle_gaps`` names each gap by the innermost host span of
the benchmark or the port (``bench/``, ``cy/``) open at its start and by
its kind, and ``split`` adds, an update of the traced window, the idle ms
of each kind (``host_wait_ms_per_step`` and the others), the share of
device intervals whose launch was found, the port's span totals (host ms
an update by span), and the device-side mirrors of other annotations that
``trace.read_profile`` counts as busy, with the busy time an update
without them. Prints the result line last.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(1, str(Path(__file__).resolve().parents[1]))   # the port's package

from portbench import harness, spans  # noqa: E402
from portbench.trace import Trace  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    records = []
    window = harness.run_window

    def run_window(runner, rec, *rest):
        window(runner, rec, *rest)
        records.append(rec)

    harness.read_profile, harness.run_window = spans.read_profile, run_window
    result = harness.run(args.workload, args.seed, args.seconds, True, t_start=T_START)
    rec = records[0]
    t, n = rec.trace, rec.traced_updates
    split = {f"{kind}_ms_per_step": t.idle_s(kind) / n * 1e3
             for kind in ("host", "queued", "in_graph", "unlinked")}
    split["host_wait_ms_per_step"] = split.pop("host_ms_per_step")
    try:
        from contrastyou_tpu_torch.tracing import SPAN_TOTALS
        split["span_ms_per_step"] = {k: ns * 1e-6 / n for k, (_, ns) in sorted(SPAN_TOTALS.items())}
    except ImportError:
        pass
    bare = Trace([k for k in t.kernels if k[2] not in t.other_mirrors], t.spans, t.window_s)
    split.update(traced_updates=n, linked_share=t.linked_share(),
                 other_mirrors_s=t.other_mirrors,
                 busy_without_other_mirrors_ms_per_step=bare.busy_s() / n * 1e3,
                 idle_gaps=t.idle_gaps(top=24))
    result["split"] = split
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
