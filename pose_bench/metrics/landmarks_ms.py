"""landmarks_ms: the landmark model's milliseconds a clip (HRNet or the
int8 HRNet on the clip's crops), CUDA events from forward hooks on it, the
mean over the spans stretch's clips."""


def read(ctx):
    spans = [c["landmarks"] for c in ctx.get("spans", ()) if "landmarks" in c]
    return sum(spans) / len(spans) if spans else None
