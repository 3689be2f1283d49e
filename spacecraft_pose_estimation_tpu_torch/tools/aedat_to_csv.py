"""AEDAT-4 recording -> events CSV (v2e/aedat_to_csv.py's command).

Port of ``tools/aedat_to_csv.py``: header-less rows ``t,x,y,p`` with t in
microseconds from the first event and polarity 0/1, written in chunks so
large recordings stream through bounded memory (aedat_to_csv.py:23-45).
The AEDAT-4 container is read by ``events/aedat4.py`` (LZ4 packets through
the repository's codec, built at first use). Runs on the host.

    python -m spacecraft_pose_estimation_tpu_torch.tools.aedat_to_csv --events_file REC.aedat4 --output_file OUT.csv
"""

from __future__ import annotations

import argparse
from typing import Sequence

import numpy as np

from ..events.aedat4 import read_aedat4


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Convert an aedat4 file to csv.")
    ap.add_argument("--events_file", required=True, help="aedat4 format file")
    ap.add_argument("--output_file", required=True, help="path for csv output")
    ap.add_argument("--chunk", type=int, default=2_000_000, help="rows per write")
    return ap


def main(argv: Sequence[str] | None = None) -> int:
    """The command; returns the number of events written."""
    args = build_parser().parse_args(argv)
    ev = read_aedat4(args.events_file)  # (N, 4) int64 [t_us, x, y, p]
    if len(ev):
        ev[:, 0] -= ev[0, 0]  # offset from the first event (reference :27-28)
    with open(args.output_file, "w") as f:
        for start in range(0, max(len(ev), 1), args.chunk):
            chunk = ev[start:start + args.chunk]
            if len(chunk) == 0:
                break
            np.savetxt(f, chunk, fmt="%d", delimiter=",")
    print(f"wrote {args.output_file} ({len(ev)} events)")
    return len(ev)


if __name__ == "__main__":
    main()
