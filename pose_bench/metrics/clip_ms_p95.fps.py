"""clip_ms_p95.fps: the 95th percentile of every window clip's latency (as
the end-to-end ``clip_ms_p95``), reported per layer in the cells whose
tail spreads too widely across hosts to hold a bound; there it moves
``frames_per_s``."""


def read(ctx):
    return ctx.get("clip_ms_p95")
