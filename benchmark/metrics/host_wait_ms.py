"""Host ms of the program's ``sync.*`` spans (every call of a frame that
makes the host wait for the card), summed, in the last frame rendered
without the profiler (the port's telemetry record)."""

from harness import program_trace


def read(ctx):
    if ctx.get("kind") != "frame":
        return None
    return program_trace.span_host_ms(program_trace.unprofiled_frame(),
                                      "sync")
