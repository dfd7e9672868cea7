"""Procedural scenes (port of royaltracer_dx_tpu/scene/procedural.py).

``cornell_box``, ``menger_sponge``, ``heightfield``, ``displaced_sphere``
and ``many_lights`` match the JAX package vertex for vertex;
``menger_scene`` is the recipe of the JAX CLI's ``--scene menger``
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


def _quad(a, b, c, d):
    """Two triangles for quad a-b-c-d (ccw)."""
    return [a, b, c], [a, c, d]


def heightfield(res: int = 708, extent: float = 2.0, seed: int = 0):
    """fBm-displaced heightfield grid → (vertices [V,3], indices [T,3]).

    res=708 gives ~1.0M triangles — the BASELINE.json config-3 operating
    point (bunny/dragon-class compact surface, generated procedurally
    like every asset of the repository).  Smooth multi-octave sines so
    normals/derivatives are well behaved.
    """
    x = np.linspace(-extent, extent, res, dtype=np.float32)
    z = np.linspace(-extent, extent, res, dtype=np.float32)
    xx, zz = np.meshgrid(x, z, indexing="ij")
    rng = np.random.default_rng(seed)
    y = np.zeros_like(xx)
    for octave in range(5):
        f = 1.5 * 2.0 ** octave
        ax, az = rng.uniform(0, 6.28, 2)
        y += (0.5 ** octave) * 0.35 * (
            np.sin(f * xx + ax) * np.cos(f * zz + az))
    verts = np.stack([xx, y, zz], axis=-1).reshape(-1, 3).astype(np.float32)
    i = np.arange(res - 1)
    j = np.arange(res - 1)
    ii, jj = np.meshgrid(i, j, indexing="ij")
    v00 = (ii * res + jj).ravel()
    v01 = v00 + 1
    v10 = v00 + res
    v11 = v10 + 1
    # winding chosen so geometric normals point +y (v6 shading does not
    # flip normals toward the ray; downward-facing terrain renders black)
    tris = np.concatenate(
        [np.stack([v00, v01, v10], axis=-1),
         np.stack([v01, v11, v10], axis=-1)], axis=0).astype(np.int32)
    return verts, tris


def displaced_sphere(subdiv: int = 512, seed: int = 0):
    """fBm-displaced UV sphere → (vertices, indices), ~2*subdiv^2 tris.

    subdiv=707 ≈ 1.0M triangles; a closed dragon-class blob for traversal
    benchmarks (compact surface, misses exit quickly).
    """
    u = np.linspace(0, 2 * np.pi, subdiv, endpoint=False, dtype=np.float32)
    v = np.linspace(1e-3, np.pi - 1e-3, subdiv, dtype=np.float32)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    rng = np.random.default_rng(seed)
    r = np.ones_like(uu)
    for octave in range(4):
        f = 3.0 * 2.0 ** octave
        au, av = rng.uniform(0, 6.28, 2)
        r += (0.45 ** (octave + 1)) * np.sin(f * uu + au) * np.sin(f * vv + av)
    x = r * np.sin(vv) * np.cos(uu)
    y = r * np.cos(vv)
    z = r * np.sin(vv) * np.sin(uu)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3).astype(np.float32)
    i = np.arange(subdiv, dtype=np.int64)
    j = np.arange(subdiv - 1, dtype=np.int64)
    ii, jj = np.meshgrid(i, j, indexing="ij")
    v00 = (ii * subdiv + jj).ravel()
    v01 = v00 + 1
    v10 = (((ii + 1) % subdiv) * subdiv + jj).ravel()
    v11 = v10 + 1
    tris = np.concatenate(
        [np.stack([v00, v10, v01], axis=-1),
         np.stack([v01, v10, v11], axis=-1)], axis=0).astype(np.int32)
    return verts, tris


def many_lights(n_lights: int = 64, n_boxes: int = 48, seed: int = 1,
                emission: float = 40.0) -> Scene:
    """Sponza-class MANY-LIGHT workload (BASELINE config 4), procedural.

    A dark hall: floor + back wall, a grid of n_lights small emissive
    ceiling panels with randomized colors/intensities (stresses the
    light-CDF + RIS candidate machinery the way Sponza's many lamps
    would), and random diffuse/metallic boxes casting shadows.
    Camera: eye=(0, 1.1, 3.2) center=(0, 0.8, 0).
    """
    rng = np.random.default_rng(seed)
    s = Scene()
    gray = s.add_material(kd=(0.55, 0.55, 0.55, 1.0), ks=(0, 0, 0),
                          pr_pm_ps_pc=(1, 0, 0, 0))

    verts, tris, mats = [], [], []

    def add_quad(quad, mid):
        base = len(verts)
        verts.extend(quad)
        t1, t2 = _quad(base, base + 1, base + 2, base + 3)
        tris.extend([t1, t2])
        mats.extend([mid, mid])

    # floor [-2,2]^2 at y=0, back wall at z=-2, ceiling at y=2
    add_quad([(-2, 0, 2), (2, 0, 2), (2, 0, -2), (-2, 0, -2)], gray)
    add_quad([(-2, 0, -2), (2, 0, -2), (2, 2, -2), (-2, 2, -2)], gray)
    add_quad([(-2, 2, -2), (2, 2, -2), (2, 2, 2), (-2, 2, 2)], gray)

    # grid of emissive panels just below the ceiling
    g = int(np.ceil(np.sqrt(n_lights)))
    k = 0
    for i in range(g):
        for j in range(g):
            if k >= n_lights:
                break
            k += 1
            color = rng.uniform(0.3, 1.0, 3)
            inten = emission * rng.uniform(0.3, 1.5)
            mid = s.add_material(kd=(0, 0, 0, 1.0), ks=(0, 0, 0),
                                 ke=tuple(color * inten),
                                 pr_pm_ps_pc=(1, 0, 0, 0))
            cx = -1.8 + 3.6 * (i + 0.5) / g
            cz = -1.8 + 3.6 * (j + 0.5) / g
            r = 0.45 / g * 3.6 * 0.5
            add_quad([(cx - r, 1.98, cz + r), (cx + r, 1.98, cz + r),
                      (cx + r, 1.98, cz - r), (cx - r, 1.98, cz - r)], mid)

    # random boxes on the floor (half diffuse, half metallic)
    for b in range(n_boxes):
        w, h, d = rng.uniform(0.08, 0.35, 3)
        cx, cz = rng.uniform(-1.7, 1.7, 2)
        metal = float(b % 2)
        rough = float(rng.uniform(0.1, 0.9))
        kd = tuple(rng.uniform(0.2, 0.9, 3)) + (1.0,)
        mid = s.add_material(kd=kd, ks=(0.9, 0.9, 0.9) if metal else (0, 0, 0),
                             pr_pm_ps_pc=(rough, metal, 0, 0))
        x0, x1 = cx - w, cx + w
        z0, z1 = cz - d, cz + d
        add_quad([(x0, 0, z1), (x1, 0, z1), (x1, h, z1), (x0, h, z1)], mid)
        add_quad([(x1, 0, z0), (x0, 0, z0), (x0, h, z0), (x1, h, z0)], mid)
        add_quad([(x0, 0, z0), (x0, 0, z1), (x0, h, z1), (x0, h, z0)], mid)
        add_quad([(x1, 0, z1), (x1, 0, z0), (x1, h, z0), (x1, h, z1)], mid)
        add_quad([(x0, h, z1), (x1, h, z1), (x1, h, z0), (x0, h, z0)], mid)

    mesh = s.add_mesh(
        np.asarray(verts, np.float32),
        np.asarray(tris, np.int32),
        normals=None,
        tri_material=np.asarray(mats, np.int32),
    )
    s.add_instance(mesh)
    return s
