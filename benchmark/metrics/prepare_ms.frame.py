"""Worklists and presort (``stream_trace.prepare_stream`` and
``coherence_order``) of the traced frame: CUDA events in the benchmark's
wrappers, summed, in ms."""


def read(ctx):
    if ctx.get("kind") != "frame":
        return None
    return ctx.get("prepare_ms")
