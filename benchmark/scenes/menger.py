"""Scene kind ``menger``: a white Menger sponge of ``levels`` levels under
a 2-triangle ceiling light (the port's ``procedural.menger_scene``; the
reference generates the same mesh itself)."""


def program(config: dict):
    from royaltracer_dx_tpu_torch.scene.procedural import menger_scene

    scene, _ = menger_scene(int(config["scene"]["levels"]))
    return scene, None


def reference(config: dict, path):
    from reference import scene as rscene

    return rscene.menger(int(config["scene"]["levels"]))
