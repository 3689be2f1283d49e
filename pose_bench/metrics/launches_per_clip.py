"""launches_per_clip: kernel launches in the profiled stretch over its clips."""


def read(ctx):
    prof = ctx.get("profile")
    if not prof or not prof["launches"]:
        return None
    return prof["launches"] / ctx["profile_clips"]
