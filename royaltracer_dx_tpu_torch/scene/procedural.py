"""Procedural scenes (port of royaltracer_dx_tpu/scene/procedural.py).

``cornell_box`` and ``menger_sponge`` match the JAX package vertex for
vertex; ``menger_scene`` is the recipe of the JAX CLI's ``--scene menger``
(cli.py:86-98) as a function; ``random_tris`` is the traversal soup.
"""

from __future__ import annotations

import numpy as np

from royaltracer_dx_tpu_torch.camera import Camera
from royaltracer_dx_tpu_torch.scene.scene import Scene


def cornell_box(light_scale: float = 1.0, emission: float = 15.0) -> Scene:
    """Cornell box in [0,1]^3 with a ceiling light (procedural.py:26-90)."""
    s = Scene()
    white = s.add_material(kd=(0.73, 0.73, 0.73, 1.0), ks=(0, 0, 0),
                           pr_pm_ps_pc=(1, 0, 0, 0))
    red = s.add_material(kd=(0.65, 0.05, 0.05, 1.0), ks=(0, 0, 0),
                         pr_pm_ps_pc=(1, 0, 0, 0))
    green = s.add_material(kd=(0.12, 0.45, 0.15, 1.0), ks=(0, 0, 0),
                           pr_pm_ps_pc=(1, 0, 0, 0))
    light = s.add_material(kd=(0.0, 0.0, 0.0, 1.0), ks=(0, 0, 0),
                           ke=(emission, emission, emission),
                           pr_pm_ps_pc=(1, 0, 0, 0))
    verts: list = []
    tris: list = []
    mats: list = []

    def add_quad(a, b, c, d, mat):
        base = len(verts)
        verts.extend([a, b, c, d])
        tris.extend([[base, base + 1, base + 2], [base, base + 2, base + 3]])
        mats.extend([mat, mat])

    add_quad((0, 0, 1), (1, 0, 1), (1, 0, 0), (0, 0, 0), white)
    add_quad((0, 1, 0), (1, 1, 0), (1, 1, 1), (0, 1, 1), white)
    add_quad((1, 0, 0), (1, 1, 0), (0, 1, 0), (0, 0, 0), white)
    add_quad((0, 0, 0), (0, 1, 0), (0, 1, 1), (0, 0, 1), red)
    add_quad((1, 0, 1), (1, 1, 1), (1, 1, 0), (1, 0, 0), green)

    def add_box(lo, hi, mat):
        x0, y0, z0 = lo
        x1, y1, z1 = hi
        add_quad((x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1), mat)
        add_quad((x1, y0, z0), (x0, y0, z0), (x0, y1, z0), (x1, y1, z0), mat)
        add_quad((x0, y0, z0), (x0, y0, z1), (x0, y1, z1), (x0, y1, z0), mat)
        add_quad((x1, y0, z1), (x1, y0, z0), (x1, y1, z0), (x1, y1, z1), mat)
        add_quad((x0, y1, z1), (x1, y1, z1), (x1, y1, z0), (x0, y1, z0), mat)

    add_box((0.10, 0.0, 0.12), (0.45, 0.60, 0.45), white)
    add_box((0.55, 0.0, 0.50), (0.85, 0.30, 0.80), white)

    half = 0.18 * light_scale
    cx, cz, y = 0.5, 0.45, 0.999
    add_quad((cx - half, y, cz - half), (cx + half, y, cz - half),
             (cx + half, y, cz + half), (cx - half, y, cz + half), light)

    mesh = s.add_mesh(np.asarray(verts, np.float32),
                      np.asarray(tris, np.int32), normals=None,
                      tri_material=np.asarray(mats, np.int32))
    s.add_instance(mesh)
    return s


def menger_sponge(levels: int = 2):
    """Menger-sponge cube faces -> (vertices [V, 3], indices [T, 3])
    (procedural.py:93-130, DXRHelper.h:184-344).  levels=2 -> 400 cubes =
    4,800 triangles."""
    cubes = [(np.zeros(3), 1.0)]
    for _ in range(levels):
        nxt = []
        for origin, size in cubes:
            step = size / 3.0
            for i in range(3):
                for j in range(3):
                    for k in range(3):
                        if (i == 1) + (j == 1) + (k == 1) >= 2:
                            continue
                        nxt.append((origin + np.array([i, j, k]) * step, step))
        cubes = nxt
    verts = []
    tris = []
    corners = np.array(
        [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
         [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.float32)
    faces = [(0, 3, 2, 1), (4, 5, 6, 7), (0, 1, 5, 4),
             (2, 3, 7, 6), (0, 4, 7, 3), (1, 2, 6, 5)]
    for origin, size in cubes:
        base = len(verts)
        verts.extend(origin + corners * size)
        for a, b, c, d in faces:
            tris.append([base + a, base + b, base + c])
            tris.append([base + a, base + c, base + d])
    return np.asarray(verts, np.float32), np.asarray(tris, np.int32)


def menger_scene(levels: int = 2) -> tuple[Scene, Camera]:
    """The JAX CLI's ``--scene menger`` (cli.py:86-98): a white
    menger_sponge(levels) under a 2-triangle ceiling light, and its
    camera."""
    s = Scene()
    v, idx = menger_sponge(levels)
    white = s.add_material(kd=(0.7, 0.7, 0.7, 1.0), ks=(0, 0, 0))
    light = s.add_material(ke=(20.0, 20.0, 20.0))
    mesh = s.add_mesh(v, idx,
                      tri_material=np.full(len(idx), white, np.int32))
    s.add_instance(mesh)
    lv = np.array([[0.2, 1.4, 0.2], [0.8, 1.4, 0.2], [0.8, 1.4, 0.8],
                   [0.2, 1.4, 0.8]], np.float32)
    lm = s.add_mesh(lv, np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
                    tri_material=np.asarray([light, light], np.int32))
    s.add_instance(lm)
    return s, Camera(eye=(2.2, 1.6, 2.2), center=(0.5, 0.5, 0.5))


def random_tris(n: int, seed: int = 0, extent: float = 1.0,
                size: float = 0.02):
    """Random triangle soup (procedural.py:133-141)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-extent, extent, (n, 1, 3)).astype(np.float32)
    offsets = rng.normal(0.0, size, (n, 3, 3)).astype(np.float32)
    verts = (centers + offsets).reshape(-1, 3)
    indices = np.arange(n * 3, dtype=np.int32).reshape(-1, 3)
    return verts, indices
