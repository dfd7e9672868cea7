"""Device ms of the kernels launched inside the program's ``rt.update``
span (a renderer's ``update()``: world bake, accel refit, light and
triangle tables) in the traced frame with host operations
(harness/program_trace.py); None where the trace has no such span."""

from harness import program_trace


def read(ctx):
    if ctx.get("kind") != "frame":
        return None
    return program_trace.range_device_ms("update")
