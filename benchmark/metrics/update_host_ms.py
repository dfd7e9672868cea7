"""Host ms of the program's ``update`` span (a renderer's ``update()``:
the world bake, the accel refit, the light table, the triangle table and
their host waits) in the newest update made without the profiler, the
first frame of the traced work (the port's telemetry record); None where
the program keeps no record of updates."""

from harness import program_trace


def read(ctx):
    if ctx.get("kind") != "frame":
        return None
    tel = program_trace.telemetry()
    last = getattr(tel, "last_update", None)
    up = last(profiled=False) if last is not None else None
    if up is None:
        return None
    ms = [1e-6 * (b - a) for n, a, b in up["spans"] if n == "update"]
    return ms[-1] if ms else None
