"""detect_ms: the detector's milliseconds a clip (``PoseServer.detect``:
letterbox, the trunk, FPN, RPN, ROI heads, best box), CUDA events around
the call, the mean over the spans stretch's clips."""


def read(ctx):
    spans = [c["detect"] for c in ctx.get("spans", ()) if "detect" in c]
    return sum(spans) / len(spans) if spans else None
