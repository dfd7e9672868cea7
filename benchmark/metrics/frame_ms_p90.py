"""90th percentile of the window's frame times (host clock, each frame
ending in its own wait), in ms; frame cells only."""


def read(ctx):
    v = sorted(ctx.get("frame_ms") or [])
    if not v:
        return None
    pos = 0.9 * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
