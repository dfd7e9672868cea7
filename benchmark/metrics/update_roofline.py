"""The scene update's share of its roofline in the traced frame, in %: the
least time of the bytes an update must move at the reference scene's
triangle count over the device time of the kernels launched inside
``rt.update`` (``update_device_ms``).

The bytes are those a refit of the world and of the two-level accel must
move, whatever code moves them; they never read the program.  A triangle:
its object-space vertices and normals read (72 bytes); its world vertices
and normals and the accel's triangle tile (v0, e1, e2) written (108
bytes).  A box of the accel (every cluster of ``G`` triangles and every
block of ``S`` clusters of the median build, padded to a power of two as
``harness/yardstick.py`` builds it): 24 bytes written.  Least time =
bytes / ``PEAK_HBM``."""

from harness import program_trace
from harness.yardstick import G, PEAK_HBM, S

TRI_READ = 72
TRI_WRITTEN = 108
BOX = 24


def update_bytes(triangles: int) -> int:
    slots = max(S * G, 1 << (int(triangles) - 1).bit_length())
    clusters = slots // G
    return (int(triangles) * (TRI_READ + TRI_WRITTEN)
            + BOX * (clusters + clusters // S))


def least_seconds(triangles: int) -> float:
    return update_bytes(triangles) / PEAK_HBM


def read(ctx):
    if ctx.get("kind") != "frame" or not ctx.get("update_tris"):
        return None
    ms = program_trace.range_device_ms("update")
    if not ms:
        return None
    return 100.0 * least_seconds(ctx["update_tris"]) / (1e-3 * ms)
