"""Share of a frame in which no kernel, copy or memset runs on the card,
in %: the device's busy time in the traced frame (the profile of CUDA
activity alone) over the window's mean frame time (host clock,
unprofiled).  The profiler stretches a frame that the host paces, but not
the device's work, so the traced frame's own span would read the
profiler."""


def read(ctx):
    if ctx.get("kind") != "frame":
        return None
    v = ctx.get("frame_ms") or []
    busy = ctx["lean"]["busy_s"]
    if not v or not busy:
        return None
    return 100.0 * (1.0 - 1e3 * busy / (sum(v) / len(v)))
