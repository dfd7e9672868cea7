"""Scene kind ``dragon_stage``: the CLI's ``--scene dragon`` stage
(``cli.build_scene("dragon")``) with its dragon facing out.  The
generated dragon-scale asset (``scene/assets.py`` ``generate_dragon``)
is written once as OBJ + MTL into the checkout's ``assets/``; it is wound
into its tube, so its shading normals face away from a camera outside it.
``outward`` writes a copy beside it with every face's corners reversed
and every normal negated (``<asset>_outward.obj``, the same MTL), which a
closed scanned mesh such as the Stanford dragon is: both sides load that
copy.  It is instance 0, a grey ground quad under it instance 1 and an
emissive quad above it instance 2, both sized from the model's bounding
box by the CLI's arithmetic (``_quads``).  The scene spec's keys other
than ``kind`` and ``asset`` are the generator's arguments (``nu``,
``nv``); a file that another configuration wrote with other arguments
has another triangle count than this configuration states, and is
written anew."""

import os

import numpy as np


def outward(path: str) -> str:
    """The OBJ at ``path`` turned inside out: each face's corners after
    the first reversed, each ``vn`` negated (the text's sign flipped, so
    the numbers are exact); written once, and again when ``path`` is
    newer.  Returns the copy's path."""
    out = os.path.splitext(path)[0] + "_outward.obj"
    if (os.path.exists(out)
            and os.path.getmtime(out) >= os.path.getmtime(path)):
        return out
    lines = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("vn "):
                t = line.split()[1:]
                line = "vn " + " ".join(
                    x[1:] if x[0] == "-" else "-" + x for x in t) + "\n"
            elif line.startswith("f "):
                t = line.split()
                line = " ".join(t[:2] + t[:1:-1]) + "\n"
            lines.append(line)
    tmp = out + ".tmp"
    with open(tmp, "w") as fh:
        fh.writelines(lines)
    os.replace(tmp, out)
    return out


def _quads(v: np.ndarray):
    """(ground corners, light corners) of the CLI's stage around the
    vertices ``v``, float32 [4, 3] each."""
    lo, hi = v.min(axis=0), v.max(axis=0)
    ground_y = float(lo[1]) - 0.02
    ext = float(max(hi[0] - lo[0], hi[2] - lo[2])) * 2.0
    gv = np.array([[-ext, ground_y, -ext], [ext, ground_y, -ext],
                   [ext, ground_y, ext], [-ext, ground_y, ext]], np.float32)
    ly = float(hi[1]) + 0.35 * ext
    lv = np.array([[-0.25 * ext, ly, -0.25 * ext],
                   [0.25 * ext, ly, -0.25 * ext],
                   [0.25 * ext, ly, 0.25 * ext],
                   [-0.25 * ext, ly, 0.25 * ext]], np.float32)
    return gv, lv


GROUND = [[0, 2, 1], [0, 3, 2]]
LIGHT = [[0, 1, 2], [0, 2, 3]]
GREY = dict(kd=(0.55, 0.55, 0.55, 1.0))
LAMP = dict(ke=(18.0, 17.0, 15.0))


def _program_stage(path: str):
    from royaltracer_dx_tpu_torch.scene.scene import Scene

    s = Scene()
    mesh = s.add_obj(path)
    s.add_instance(mesh)
    gv, lv = _quads(s.meshes[mesh].vertices)
    grey = s.add_material(**GREY)
    light = s.add_material(**LAMP)
    for v, f, m in ((gv, GROUND, grey), (lv, LIGHT, light)):
        s.add_instance(s.add_mesh(v, np.asarray(f, np.int32),
                                  tri_material=np.asarray([m, m], np.int32)))
    return s


def program(config: dict):
    from royaltracer_dx_tpu_torch.scene.assets import ensure_asset

    spec = config["scene"]
    kw = {k: v for k, v in spec.items() if k not in ("kind", "asset")}
    src = ensure_asset(spec["asset"], **kw)
    path = outward(src)
    scene = _program_stage(path)
    if scene.num_triangles != int(config["triangles"]):
        os.remove(src)
        path = outward(ensure_asset(spec["asset"], **kw))
        scene = _program_stage(path)
    return scene, path


def reference(config: dict, path):
    from reference import scene as rscene

    s = rscene.empty_scene()
    mesh = rscene.load_obj(s, path)
    s.add_instance(mesh)
    gv, lv = _quads(s.meshes[mesh].vertices)
    grey = s.add_material(**GREY)
    light = s.add_material(**LAMP)
    for v, f, m in ((gv, GROUND, grey), (lv, LIGHT, light)):
        s.add_instance(s.add_mesh(v, f, [m, m]))
    return s
