"""Share of a wavefront in which no kernel, copy or memset runs on the
card, in %: the device's busy time in the traced wavefront (the profile
of CUDA activity alone) over the window's mean wavefront time (host
clock, unprofiled)."""


def read(ctx):
    if ctx.get("kind") != "wavefront":
        return None
    wave_ms = ctx.get("wave_ms")
    busy = ctx["lean"]["busy_s"]
    if not wave_ms or not busy:
        return None
    return 100.0 * (1.0 - 1e3 * busy / wave_ms)
