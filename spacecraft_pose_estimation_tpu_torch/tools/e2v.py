"""Events CSV -> frames (v2e/e2v.py:28-141's command).

Port of ``tools/e2v.py``: reads ``t,x,y,p`` CSV (timestamp unit flags, an
optional xy swap, polarity collapsed to +1 as the reference does), bins
the events into duration-exposure frames and writes ``{t}.bmp`` files and
a ``frame_times.txt`` list. The frames are summed on ``--device`` (cuda
unless given ``cpu``; float64, so equal to the JAX tool's numpy sums);
reading the CSV and writing the images run on the host.

    python -m spacecraft_pose_estimation_tpu_torch.tools.e2v -i events.csv -o OUT --width 346 --height 260 \
        [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Sequence

import torch

from ..device import resolve_device
from ..events import io as ev_io


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Events CSV -> duration-exposure frames (e2v)")
    ap.add_argument("-i", "--input", required=True, help="events CSV")
    ap.add_argument("-o", "--output-folder", required=True)
    ap.add_argument("--width", type=int, required=True)
    ap.add_argument("--height", type=int, required=True)
    ap.add_argument("--timestamp-unit", choices=["s", "ms", "us"], default="s")
    ap.add_argument("--swap-xy", action="store_true")
    ap.add_argument("--delim_whitespace", action="store_true", default=None,
                    help="input is space-separated (v2e --dvs_text contract); default sniffs the first data line")
    ap.add_argument("--keep-polarity", action="store_true", help="keep -1/+1 instead of the reference's force-positive")
    ap.add_argument("--exposure", type=float, default=0.01, help="seconds per frame")
    ap.add_argument("--full-scale-count", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv: Sequence[str] | None = None) -> list[float]:
    """The command; returns the frames' end times in ms."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    import cv2

    events = ev_io.read_events_csv(args.input, timestamp_unit=args.timestamp_unit, swap_xy=args.swap_xy,
                                   force_pos_polarity=not args.keep_polarity, delim_whitespace=args.delim_whitespace)
    if len(events) == 0:
        print("no events")
        return []
    os.makedirs(args.output_folder, exist_ok=True)
    frame_times = []
    for img01, t_end in ev_io.accumulate_exposure_frames(events, args.width, args.height, args.exposure,
                                                         args.full_scale_count, device=device):
        img = (img01 * 255).to(torch.uint8).cpu().numpy()
        t_ms = t_end * 1e3
        cv2.imwrite(os.path.join(args.output_folder, f"{t_ms:.0f}.bmp"), cv2.cvtColor(img, cv2.COLOR_GRAY2BGR))
        frame_times.append(t_ms)
    with open(os.path.join(args.output_folder, "frame_times.txt"), "w") as f:
        f.writelines(f"{t:.3f}\n" for t in frame_times)
    print(f"wrote {len(frame_times)} frames to {args.output_folder}")
    return frame_times


if __name__ == "__main__":
    main()
