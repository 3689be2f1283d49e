"""Run one cell of the pose server's benchmark once.

    python3 pose_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this folder and
the ``spacecraft_pose_estimation_tpu_torch`` package, on a machine with the
CUDA cards the cell asks for. The last line of standard output is the
result as one JSON object; the numbers the comparison held to their limits
are the last lines of standard error too. Exits non-zero, printing no
result, without the cards, without the package, or when JAX, Flax or the
JAX package is loaded once the window has closed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# caches at fixed paths inside the checkout (the port's kernels build into its own _build/)
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "pose_bench" / ".cache" / "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(ROOT / "pose_bench" / ".cache" / "inductor")
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch

    from pose_bench import harness

    chips = harness.Spec(ROOT).workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = harness.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), T_PROCESS)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"modules of JAX, Flax or the JAX package are loaded: {loaded}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
