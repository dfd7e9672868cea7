"""CUDA kernels launched in the traced frame (the profiler's kernel
events)."""


def read(ctx):
    if ctx.get("kind") != "frame":
        return None
    return ctx["summary"]["launches"] or None
