"""Random 70/15/15 train/validation/test split of a frame folder (port of ``tools/split_images.py``).

    python -m spacecraft_pose_estimation_tpu_torch.tools.split_images --input-dir FRAMES \\
        --output-dir SPLIT [--fractions 0.7 0.15 0.15] [--seed S] [--move]

The frames (``.png``, ``.jpg``, ``.jpeg``, ``.bmp``) in sorted order go
through ``coco_io.split_files`` and are copied (or moved) to
``SPLIT/train``, ``SPLIT/validation`` and ``SPLIT/test``. A file operation
on the host: it takes no device.
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import Sequence

from ..data.coco_io import split_files


def main(argv: Sequence[str] | None = None) -> dict[str, list[str]]:
    """The command; also a function: returns each split's file names."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input-dir", required=True)
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--fractions", nargs=3, type=float, default=[0.7, 0.15, 0.15])
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--move", action="store_true", help="move instead of copy")
    args = ap.parse_args(argv)

    files = sorted(f for f in os.listdir(args.input_dir) if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")))
    splits = split_files(files, tuple(args.fractions), seed=args.seed)
    op = shutil.move if args.move else shutil.copy2
    for split, names in splits.items():
        out = os.path.join(args.output_dir, split)
        os.makedirs(out, exist_ok=True)
        for f in names:
            op(os.path.join(args.input_dir, f), os.path.join(out, f))
        print(f"{split}: {len(names)} frames")
    return splits


if __name__ == "__main__":
    main()
