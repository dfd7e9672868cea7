"""Host ms of the program's ``pass2_temporal`` span (pass 2, temporal reuse (``_pack_last`` included)) in
the last frame rendered without the profiler, the first frame of the
traced work (the port's telemetry record)."""

from harness import program_trace


def read(ctx):
    if ctx.get("kind") != "frame":
        return None
    return program_trace.span_host_ms(program_trace.unprofiled_frame(),
                                      "pass2_temporal")
