"""Device ms of the kernels launched inside the program's ``rt.pass2_temporal``
span in the traced frame: pass 2, temporal reuse (``_pack_last`` included), its
traces and their worklists and presort included (harness/program_trace.py)."""

from harness import program_trace


def read(ctx):
    if ctx.get("kind") != "frame":
        return None
    return program_trace.range_device_ms("pass2_temporal")
