"""A configuration's scene, built twice from the same inputs: by the
program (the port's ``scene/*``, ``camera.py`` and ``config.py``) and by
the plain reference (``reference/``), which reads the same raw file or
generates the same procedural mesh itself.  The scene kind,
``config["scene"]["kind"]``, is the file ``scenes/<kind>.py``: its
``program(config)`` returns the port's Scene and the raw input's path (or
None), its ``reference(config, path)`` the reference's scene input.  Both
sides are held to the configuration's ``triangles``, and both take the
whole ``render`` block (the reference refuses keys it does not model)."""

from __future__ import annotations

import numpy as np
import torch

from harness.manifest import BENCH_DIR, ManifestError, load_plugin


def _count(side: str, config: dict, n: int) -> None:
    if n != int(config["triangles"]):
        raise ManifestError(
            f"{config.get('name', 'config')}: the {side}'s scene has {n} "
            f"triangles, the configuration states {config['triangles']}")


def program_scene(config: dict, bench_dir: str = BENCH_DIR):
    """(port Scene, port Camera, raw input path or None)."""
    from royaltracer_dx_tpu_torch.camera import Camera

    kind = load_plugin("scenes", config["scene"]["kind"], bench_dir)
    scene, path = kind.program(config)
    _count("program", config, scene.num_triangles)
    cam = config["camera"]
    return scene, Camera(eye=tuple(cam["eye"]), center=tuple(cam["center"])), path


def program_config(config: dict):
    """The port's RenderConfig of the configuration's ``render`` block."""
    from royaltracer_dx_tpu_torch.config import RenderConfig

    return RenderConfig(**config["render"])


def reference_scene(config: dict, path: str | None, device,
                    bench_dir: str = BENCH_DIR):
    """(reference SceneArrays, reference camera arrays, reference
    RenderConfig) of ``config``."""
    from reference import camera as rcam
    from reference import scene as rscene
    from reference.config import from_render

    kind = load_plugin("scenes", config["scene"]["kind"], bench_dir)
    s = kind.reference(config, path)
    _count("reference", config, s.num_triangles)
    cfg = from_render(config["render"])
    cam = rcam.Camera(eye=tuple(config["camera"]["eye"]),
                      center=tuple(config["camera"]["center"]))
    mats = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32,
                               device=device)
            for k, v in cam.matrices(cfg.width / cfg.height).items()}
    return rscene.bake(s, device), mats, cfg
