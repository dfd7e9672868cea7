"""Device time of the stream and brute-force kernels (list and relist
kernels included) in the traced wavefront, in ms."""


def read(ctx):
    if ctx.get("kind") != "wavefront":
        return None
    ms = 1e3 * ctx["summary"]["trace_kernel_s"]
    return ms if ms > 0.0 else None
