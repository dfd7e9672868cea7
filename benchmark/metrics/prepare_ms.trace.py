"""Worklists and presort (``stream_trace.prepare_stream`` and
``coherence_order``) of the traced wavefront: CUDA events in the benchmark's
wrappers, summed, in ms."""


def read(ctx):
    if ctx.get("kind") != "wavefront":
        return None
    return ctx.get("prepare_ms")
