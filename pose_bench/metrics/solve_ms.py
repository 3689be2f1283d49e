"""solve_ms: the pose stage's milliseconds a clip less the landmark
model's (the crop, the heatmap decode and the PnP solve), CUDA events, the
mean over the spans stretch's clips. Host-paced: PnP is many small launches."""


def read(ctx):
    spans = [c["pose"] - c["landmarks"] for c in ctx.get("spans", ()) if "pose" in c and "landmarks" in c]
    return sum(spans) / len(spans) if spans else None
