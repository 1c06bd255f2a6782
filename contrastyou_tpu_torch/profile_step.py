"""Step time and device-time breakdown of the port's train steps on the card.

    python -m contrastyou_tpu_torch.profile_step pretrain_decoder [--steps 5]
    python -m contrastyou_tpu_torch.profile_step pretrain_decoder -o Data.name=prostate
    python -m contrastyou_tpu_torch.profile_step semi --udaiic

For ``semi``, ``pretrain_decoder`` or ``pretrain`` at the reference config
(full width, 224x224, bf16), with trailing ``-o`` overrides as the entry
point takes them (``Data.name=prostate``: 96 images per forward; for
``semi`` 2 classes); ``--udaiic`` starts ``semi`` from the in-code
``udaiic`` config (IIC hooks on Conv5 and Up_conv2, kernels E1/E2) instead
of ``semi`` + consistency. After warm-up, ``--rounds`` timed windows of
``--steps`` steps (host clock around synchronized steps, ms/step), then one
``torch.profiler`` window of ``--steps`` steps: device busy time per step
(the sum of the kernels' device times over the window's wall time), kernels
per step, and the largest items by device time, grouped by the operator that
launched them, and the device time of each of the port's hand-written
kernels. Every line names the card and its power limit. Needs a card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from collections import defaultdict


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def _hand_kernel(name: str):
    """The port's kernel a device event belongs to (by its CUDA function's
    name), or None for a library or PyTorch kernel."""
    if "tapmma_kernel<" in name:   # <Cout, Cin, KIND, groups, rows>: KIND 1 is K2, 2 is K3
        kind = name.split("tapmma_kernel<", 1)[1].split(",")[2].strip()
        return {"1": "K2 upconv3x3_stats", "2": "K3 upconv3x3_dx"}.get(kind, "K1 conv3x3_stats")
    for fn, label in (("conv1ch_kernel<", "K1 conv3x3_stats"), ("dw_mma_kernel<", "C1 conv_dw_taps"),
                      ("dw1ch_kernel<", "C1 conv_dw_taps"), ("convbwd_kernel<", "C2 conv3x3_bwd_fused"),
                      ("supcon_", "D1/D2 supcon"), ("iic_joints_bwd", "E2 iic_joints_bwd"),
                      ("iic_joints", "E1 iic_joints"),
                      ("sum_partials(", "partial sums of C1/C2, E1"), ("sum_dw(", "partial sums of E2")):
        if fn in name:
            return label
    return None


def _build(trainer: str, device, overrides=(), *, udaiic: bool = False, **size):
    """The run ``trainer`` with ``overrides`` on ``device``; ``size`` goes to
    the run's builder (its defaults are the reference sizes)."""
    # imported here, and the udaiic base only when asked for, so the script
    # also times older trees of the package
    from contrastyou_tpu_torch import main
    argv = ["-o", f"Trainer.name={trainer}", *overrides]
    if udaiic:
        if trainer != "semi":
            raise SystemExit("--udaiic is a semi configuration")
        config = main.parse_config(argv, main.UDAIIC_CONFIG)
    else:
        config = main.parse_config(argv)
    build = main.build_semi_run if trainer == "semi" else main.build_pretrain_run
    return build(config, device=device, **size)


def main(argv=None) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser()
    ap.add_argument("trainer", choices=("semi", "pretrain_decoder", "pretrain"))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--shapes", action="store_true",
                    help="also list the largest operators by input shapes")
    ap.add_argument("--udaiic", action="store_true",
                    help="semi with the udaiic hooks (config/hooks/udaiic.yaml)")
    ap.add_argument("-o", dest="overrides", nargs="*", default=[],
                    help="config overrides, e.g. Data.name=prostate")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA card")
    device = torch.device("cuda", 0)
    card = _card()
    run = _build(args.trainer, device, args.overrides, udaiic=args.udaiic)
    name = f"{args.trainer}/udaiic" if args.udaiic else args.trainer
    run.run(3)
    torch.cuda.synchronize()
    for r in range(args.rounds):
        t0 = time.perf_counter()
        run.run(args.steps)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / args.steps * 1e3
        print(f"{name} round {r}: {ms:.3f} ms/step, "
              f"{run.batch_slices * 1e3 / ms:.2f} slices/s on {card}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=args.shapes) as prof:
        t0 = time.perf_counter()
        run.run(args.steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    print(f"{name} profiled window: {wall_us / args.steps / 1e3:.3f} ms/step wall, "
          f"device busy {busy_us / args.steps / 1e3:.3f} ms/step "
          f"({100 * busy_us / wall_us:.1f}%), {len(kernels) / args.steps:.0f} kernels/step "
          f"on {card}")
    if not kernels:
        print("no device events in the trace")
        return 0
    by_op = defaultdict(float)
    count = defaultdict(int)
    for e in prof.key_averages(group_by_input_shape=args.shapes):
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t > 0 and e.device_type != DeviceType.CUDA:
            key = f"{e.key} {e.input_shapes}" if args.shapes else e.key
            by_op[key] += t
            count[key] += e.count
    by_kernel = defaultdict(float)
    kcount = defaultdict(int)
    for e in kernels:
        by_kernel[e.name] += e.time_range.elapsed_us()
        kcount[e.name] += 1
    for title, table, calls in (("by launching operator", by_op, count),
                                ("by kernel", by_kernel, kcount)):
        print(f"  {title}:")
        for key, t in sorted(table.items(), key=lambda kv: -kv[1])[:12]:
            print(f"    {key[:110 if args.shapes else 70]:70s} {t / args.steps / 1e3:8.3f} ms/step "
                  f"{100 * t / busy_us:5.1f}%  {calls[key] / args.steps:7.1f} calls/step")
    hand = defaultdict(float)
    hcount = defaultdict(int)
    for e in kernels:
        label = _hand_kernel(e.name)
        if label is not None:
            hand[label] += e.time_range.elapsed_us()
            hcount[label] += 1
    print("  hand-written kernels:")
    for key, t in sorted(hand.items(), key=lambda kv: -kv[1]):
        print(f"    {key:70s} {t / args.steps / 1e3:8.3f} ms/step "
              f"{100 * t / busy_us:5.1f}%  {hcount[key] / args.steps:7.1f} calls/step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
