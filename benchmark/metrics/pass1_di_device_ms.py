"""Device ms of the kernels launched inside the program's ``rt.pass1_di``
span in the traced frame: pass 1 (primary trace, RIS, visibility W), its
traces and their worklists and presort included (harness/program_trace.py)."""

from harness import program_trace


def read(ctx):
    if ctx.get("kind") != "frame":
        return None
    return program_trace.range_device_ms("pass1_di")
