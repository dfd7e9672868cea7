"""Device time of the traced frame's kernels that are neither trace
kernels nor launched inside the worklist / presort spans, in ms."""


def read(ctx):
    if ctx.get("kind") != "frame":
        return None
    s = ctx["summary"]
    ms = 1e3 * (s["kernel_s"] - s["trace_kernel_s"] - s["prepare_kernel_s"])
    return ms if ms > 0.0 else None
