"""Read the comparison's numbers for the program and for its control, over
many seeds in one process: what the limits in ``configs/<config>.json``
are set from (the program's worst over a dozen seeds or more below, the
control's least above).

    python3 pose_bench/calibrate.py --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3] [--out FILE]

For each seed: the run's set-up, the warm-up, as many clips as a run
judges, the program's numbers on them; then, for the control seeds, the
reference one precision step below the configuration's
(``Reference(precision="control")``) put in the program's place on the
same clips, judged the same way. One JSON line per seed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def read_seed(spec, workload: str, seed: int, control: bool, device: str = "cuda", build_server=None) -> dict:
    import torch

    from pose_bench import check, harness
    from pose_bench.reference import Reference, exact_float32

    w = spec.workload(workload)
    cell = harness.Cell(workload, spec.config(w["config"]), spec.traffic(w["traffic"]), torch.device(device), seed)
    tr = cell.traffic
    harness.set_up(cell, build_server)
    harness.serve(cell, 0, count=tr["warmup_clips"])
    n = tr["check_clips"]
    served = harness.serve(cell, tr["warmup_clips"], count=n)
    cell.server = None
    out = {"seed": seed, "workload": workload}
    with exact_float32():
        ref = Reference(cell.cfg, cell.det, cell.hrnet, cell.calib, cell.lm3d, tr["det_every"])
    frames = {i: harness.clip_frames(cell, i) for i, _ in served["outs"]}
    out["program"] = check.worst([check.clip_numbers(ref, frames[i], o, tr["det_every"]) for i, o in served["outs"]])
    out["failed"] = served["failed"]
    if control:
        with exact_float32():
            ctrl = Reference(cell.cfg, cell.det, cell.hrnet, cell.calib, cell.lm3d, tr["det_every"], "control")
        out["control"] = check.worst([check.clip_numbers(ref, frames[i], ctrl(frames[i]), tr["det_every"])
                                      for i, _ in served["outs"]])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    from pose_bench import harness

    spec = harness.Spec(ROOT)
    control = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    seeds += sorted(control - set(seeds))
    sink = open(args.out, "a") if args.out else None
    for seed in seeds:
        t0 = time.perf_counter()
        line = read_seed(spec, args.workload, seed, seed in control)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        if sink:
            sink.write(json.dumps(line) + "\n")
            sink.flush()
    if harness.forbidden_modules():
        print(f"JAX modules loaded: {harness.forbidden_modules()}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
