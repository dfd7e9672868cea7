"""Ray kind ``camera``: one coherent primary ray per pixel through the
pixel's corner, from the configuration's camera."""

from harness import traffic


def make(spec: dict, ctx: dict) -> dict:
    o, d = traffic.camera_rays(ctx["mats"], ctx["cfg"])
    return dict(o=o, d=d)
