"""The trace kernels' share of their roofline in the traced frame, in %:
the yardstick's least time for the traced batches (harness/yardstick.py)
over the kernels' device time."""


def read(ctx):
    if ctx.get("kind") != "frame":
        return None
    t = ctx["summary"]["trace_kernel_s"]
    if not t or ctx.get("least_s") is None:
        return None
    return 100.0 * ctx["least_s"] / t
