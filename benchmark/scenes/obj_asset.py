"""Scene kind ``obj_asset``: one of the port's generated assets
(``scene/assets.py``), written once as OBJ + MTL into the checkout's
``assets/`` and read by ``Scene.add_obj`` (the CLI's path); the
reference parses the same files itself.  The scene spec's keys other than
``kind`` and ``asset`` are the generator's arguments (``detail``).  A
file that another configuration wrote with other arguments has another
triangle count than this configuration states: it is written anew."""

import os


def _load(path):
    from royaltracer_dx_tpu_torch.scene.scene import Scene

    scene = Scene()
    scene.add_instance(scene.add_obj(path))
    return scene


def program(config: dict):
    from royaltracer_dx_tpu_torch.scene.assets import ensure_asset

    spec = config["scene"]
    kw = {k: v for k, v in spec.items() if k not in ("kind", "asset")}
    path = ensure_asset(spec["asset"], **kw)
    scene = _load(path)
    if scene.num_triangles != int(config["triangles"]):
        os.remove(path)
        path = ensure_asset(spec["asset"], **kw)
        scene = _load(path)
    return scene, path


def reference(config: dict, path):
    from reference import scene as rscene

    s = rscene.empty_scene()
    s.add_instance(rscene.load_obj(s, path))
    return s
