"""device_idle_pct: the share of the profiled stretch in which no device
activity ran (the union of kernel and copy intervals)."""


def read(ctx):
    prof = ctx.get("profile")
    if not prof or not prof["window_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
