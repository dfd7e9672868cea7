"""Ray-cluster candidate pairs the stream kernels walked in the last frame
rendered without the profiler, over the rays of its stream batches (the
port's telemetry record: the kernels' summed stats and the dispatch's
batch counts)."""

from harness import program_trace


def read(ctx):
    if ctx.get("kind") != "frame":
        return None
    fr = program_trace.unprofiled_frame()
    return program_trace.pairs_per_ray(fr, fr["batches"] if fr else ())
