"""Ray-cluster candidate pairs the stream kernels walked over every batch
traced outside a frame (set-up, the window and the traced wavefronts:
every wavefront traces the same rays), over the rays of those stream
batches (the port's telemetry record)."""

from harness import program_trace


def read(ctx):
    if ctx.get("kind") != "wavefront":
        return None
    tel = program_trace.telemetry()
    if tel is None:
        return None
    out = tel.outside_frames()
    batches = [tuple(k.split(".", 1)) + (v[1],)
               for k, v in out["batches"].items()]
    return program_trace.pairs_per_ray(out, batches)
