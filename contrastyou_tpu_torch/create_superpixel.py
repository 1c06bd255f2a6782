"""Write the SLIC superpixel maps of a dataset split (counterpart of
script/create_superpixel.py, on the port's
:func:`~contrastyou_tpu_torch.postprocess.superpixel.generate_superpixels`):
``<root>/<mode>/superpixel/<stem>.png`` beside the split's ``img`` folder,
the layout the ``acdc_superpixel`` dataset reads.

    python -m contrastyou_tpu_torch.create_superpixel <data>/ACDC_contrast \\
        --mode train --n-segments 40 --compactness 0.1
"""
from __future__ import annotations

import argparse
from pathlib import Path

from .postprocess.superpixel import generate_superpixels

__all__ = ["main"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("root", type=str, help="dataset root (contains train/val)")
    parser.add_argument("--mode", default="train", choices=("train", "val", "test"))
    parser.add_argument("--n-segments", type=int, default=40)
    parser.add_argument("--compactness", type=float, default=0.1)
    args = parser.parse_args(argv)
    written = generate_superpixels(args.root, mode=args.mode, n_segments=args.n_segments,
                                   compactness=args.compactness)
    print(f"wrote {written} superpixel maps under {Path(args.root) / args.mode / 'superpixel'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
