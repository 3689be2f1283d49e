"""mfu_pct: the clip's model FLOPs (FlopCounterMode over the reference:
the detector on the keyframes, HRNet on every crop; an int8 operation
counts as one), times the clips the window served, over the window's
seconds, over the peak of the configuration's precision."""

from pose_bench import trace


def read(ctx):
    if "clip_flops" not in ctx:
        return None
    return trace.mfu_pct(ctx["clip_flops"] * ctx["window_clips"], ctx["window_s"], ctx["cfg"]["peak_ops_per_s"])
