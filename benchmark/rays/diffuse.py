"""Ray kind ``diffuse``: ``count`` incoherent rays from area-weighted
points on the non-emissive triangles, cosine-weighted about a face normal
whose side the seed picks; the points stay for a later batch."""

from harness import traffic


def make(spec: dict, ctx: dict) -> dict:
    p, n = traffic.surface_points(ctx["sa"], int(spec["count"]), ctx["g"])
    ctx["points"][spec["name"]] = (p, n)
    return dict(o=(p + n * 1e-4).contiguous(),
                d=traffic.cosine_dirs(n, ctx["g"]).contiguous())
