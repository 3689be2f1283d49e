"""k5a_roofline_pct: K5a's share of its roofline over a clip: the least
time of every K5a launch of a clip (its bytes at the HBM bandwidth or its
operations at the int8 peak, from the launches' shapes in the spans
stretch), times the profiled clips, over K5a's kernel time in the profile."""

import contextlib

from pose_bench import trace
from pose_bench.counts.k5a import Tally

KERNEL = "int8_conv_kernel"  # the name of K5a's CUDA kernel in the profile


@contextlib.contextmanager
def tally(port, ctx):
    """K5a's bytes and operations a clip, from the shapes of its launches."""
    with Tally(port["int8_conv"]) as t:
        yield
    n = ctx["traffic"]["span_clips"]
    ctx["k5a"] = {"bytes_per_clip": t.bytes / n, "ops_per_clip": t.ops / n, "launches_per_clip": t.launches / n}


def read(ctx):
    seconds = sum(s for name, s in ctx.get("profile", {}).get("kernel_s", {}).items() if KERNEL in name)
    k5a = ctx.get("k5a")
    if not seconds or not k5a or not k5a["launches_per_clip"]:
        return None
    n = ctx["profile_clips"]
    return trace.roofline_pct(k5a["bytes_per_clip"] * n, k5a["ops_per_clip"] * n, seconds,
                              ctx["hbm_bytes_per_s"], ctx["int8_ops_per_s"])
