"""Large benchmark assets, generated deterministically and written as OBJ
(port of royaltracer_dx_tpu/scene/assets.py, host numpy).

The same generators, with the same arithmetic, so the files are byte for
byte the JAX package's:

  * ``sponza_atrium`` -- a colonnaded two-story atrium, ~265k triangles,
    14 materials, 48 emissive lamps (the Sponza workload shape).
  * ``bunny`` -- a displaced icosphere, 81,920 triangles with smooth
    vertex normals.
  * ``dragon`` -- a displaced (3,4)-torus-knot tube, 871,200 triangles.

Assets are written once into ``assets/`` at the repo root (or
$ROYALTRACER_ASSET_DIR) and read back through the OBJ loader afterwards.
"""

from __future__ import annotations

import os

import numpy as np

_DEF_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "assets")


def asset_dir() -> str:
    d = os.environ.get("ROYALTRACER_ASSET_DIR", _DEF_DIR)
    os.makedirs(d, exist_ok=True)
    return d


# ------------------------------ OBJ writer ------------------------------


def write_obj(path: str, verts: np.ndarray, faces: np.ndarray,
              face_mat: np.ndarray, materials: list[dict],
              normals: np.ndarray | None = None) -> None:
    """Minimal OBJ+MTL writer (f v//vn or f v forms), material-sorted so
    usemtl switches are rare."""
    mtl_path = os.path.splitext(path)[0] + ".mtl"
    with open(mtl_path, "w") as fh:
        for m in materials:
            fh.write(f"newmtl {m['name']}\n")
            kd = m.get("kd", (0.8, 0.8, 0.8))
            fh.write(f"Kd {kd[0]:.4f} {kd[1]:.4f} {kd[2]:.4f}\n")
            ks = m.get("ks")
            if ks:
                fh.write(f"Ks {ks[0]:.4f} {ks[1]:.4f} {ks[2]:.4f}\n")
            ke = m.get("ke")
            if ke:
                fh.write(f"Ke {ke[0]:.4f} {ke[1]:.4f} {ke[2]:.4f}\n")
            fh.write("\n")

    order = np.argsort(face_mat, kind="stable")
    faces = faces[order]
    face_mat = face_mat[order]
    lines = [f"mtllib {os.path.basename(mtl_path)}"]
    v = np.asarray(verts, np.float64)
    lines.extend(f"v {x:.6g} {y:.6g} {z:.6g}" for x, y, z in v)
    has_n = normals is not None
    if has_n:
        nn = np.asarray(normals, np.float64)
        lines.extend(f"vn {x:.4f} {y:.4f} {z:.4f}" for x, y, z in nn)
    cur = -1
    f1 = faces + 1
    for i in range(len(f1)):
        m = face_mat[i]
        if m != cur:
            lines.append(f"usemtl {materials[m]['name']}")
            cur = m
        a, b, c = f1[i]
        if has_n:
            lines.append(f"f {a}//{a} {b}//{b} {c}//{c}")
        else:
            lines.append(f"f {a} {b} {c}")
    with open(path, "w") as fh:
        fh.write("\n".join(lines))
        fh.write("\n")


def _smooth_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    fn = np.cross(verts[faces[:, 1]] - verts[faces[:, 0]],
                  verts[faces[:, 2]] - verts[faces[:, 0]])
    out = np.zeros_like(verts)
    for k in range(3):
        np.add.at(out, faces[:, k], fn)
    norm = np.linalg.norm(out, axis=1, keepdims=True)
    return (out / np.maximum(norm, 1e-12)).astype(np.float32)


# ----------------------------- primitives -------------------------------


def _grid(nx: int, ny: int):
    """Unit-square grid -> (verts [., 2] in [0,1]^2, faces)."""
    xs, ys = np.meshgrid(np.linspace(0, 1, nx + 1),
                         np.linspace(0, 1, ny + 1), indexing="ij")
    uv = np.stack([xs.ravel(), ys.ravel()], axis=1)
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    q = (i * (ny + 1) + j).ravel()
    f0 = np.stack([q, q + ny + 1, q + ny + 2], axis=1)
    f1 = np.stack([q, q + ny + 2, q + 1], axis=1)
    return uv, np.concatenate([f0, f1]).astype(np.int32)


def _ring_mesh(profile_fn, nu: int, nv: int, closed_v: bool = True):
    """Surface-of-revolution-style mesh: profile_fn(u [nu+1], v [nv(+1)])
    -> [N, 3] points; u wraps."""
    u = np.arange(nu + 1) / nu
    v = np.arange(nv + 1) / nv if not closed_v else np.arange(nv) / nv
    uu, vv = np.meshgrid(u[:-1], v, indexing="ij")       # u wraps: drop last
    pts = profile_fn(uu.ravel(), vv.ravel())
    cols = len(v)
    i, j = np.meshgrid(np.arange(nu), np.arange(cols if closed_v else cols - 1),
                       indexing="ij")
    i1 = (i + 1) % nu
    j1 = (j + 1) % cols if closed_v else j + 1
    a = i * cols + j
    b = i1 * cols + j
    c = i1 * cols + j1
    d = i * cols + j1
    f = np.concatenate([np.stack([a.ravel(), b.ravel(), c.ravel()], axis=1),
                        np.stack([a.ravel(), c.ravel(), d.ravel()], axis=1)])
    return pts.astype(np.float32), f.astype(np.int32)


def _icosphere(subdiv: int):
    t = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                 np.int64)
    for _ in range(subdiv):
        edges = {}
        nv = [tuple(p) for p in v]
        new_f = []

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in edges:
                p = v[a] + v[b]
                p /= np.linalg.norm(p)
                edges[key] = len(nv)
                nv.append(tuple(p))
            return edges[key]

        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_f += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v = np.asarray(nv, np.float64)
        f = np.asarray(new_f, np.int64)
    return v, f.astype(np.int32)


def _fbm(p: np.ndarray, octaves: int, seed: int) -> np.ndarray:
    """Smooth deterministic multi-octave field on points [N, 3] — sums of
    random-direction sinusoids (band-limited, seam-free)."""
    rng = np.random.default_rng(seed)
    out = np.zeros(p.shape[0])
    amp, freq = 1.0, 1.5
    for _ in range(octaves):
        for _k in range(3):
            d = rng.normal(size=3)
            d /= np.linalg.norm(d)
            ph = rng.uniform(0, 2 * np.pi)
            out += amp * np.sin(freq * (p @ d) + ph)
        amp *= 0.55
        freq *= 1.9
    return out


# ------------------------------- assets ---------------------------------


def generate_bunny(path: str, subdiv: int = 6) -> None:
    """Organic blob: displaced icosphere, smooth normals.  subdiv 6 ->
    81,920 triangles (bunny-scale)."""
    v, f = _icosphere(subdiv)
    disp = 1.0 + 0.22 * np.tanh(0.6 * _fbm(v, 5, seed=11))
    # ears/limbs: low-frequency lobes
    disp += 0.25 * np.maximum(0.0, _fbm(0.35 * v, 2, seed=7))
    verts = (v * disp[:, None]).astype(np.float32)
    verts[:, 1] *= 1.15
    n = _smooth_normals(verts, f)
    mats = [dict(name="fur", kd=(0.62, 0.57, 0.50), ks=(0.04, 0.04, 0.04))]
    write_obj(path, verts, f, np.zeros(len(f), np.int32), mats, normals=n)


def generate_dragon(path: str, nu: int = 1452, nv: int = 300) -> None:
    """Dragon-scale body: displaced (3,4)-torus-knot tube.  Default
    1452 x 300 x 2 = 871,200 triangles."""
    p_, q_ = 3, 4

    def prof(u, v):
        tu = 2 * np.pi * u
        tv = 2 * np.pi * v
        r = np.cos(q_ * tu) + 2.0
        cx = r * np.cos(p_ * tu)
        cy = r * np.sin(p_ * tu)
        cz = -np.sin(q_ * tu)
        # frame via derivative
        eps = 1e-4
        tu2 = tu + eps
        r2 = np.cos(q_ * tu2) + 2.0
        tx = r2 * np.cos(p_ * tu2) - cx
        ty = r2 * np.sin(p_ * tu2) - cy
        tz = -np.sin(q_ * tu2) - cz
        tl = np.sqrt(tx * tx + ty * ty + tz * tz) + 1e-12
        tx, ty, tz = tx / tl, ty / tl, tz / tl
        # normal ~ radial in xy, orthogonalized
        nx, ny, nz = cx, cy, np.zeros_like(cx)
        dot = nx * tx + ny * ty + nz * tz
        nx, ny, nz = nx - dot * tx, ny - dot * ty, nz - dot * tz
        nl = np.sqrt(nx * nx + ny * ny + nz * nz) + 1e-12
        nx, ny, nz = nx / nl, ny / nl, nz / nl
        bx = ty * nz - tz * ny
        by = tz * nx - tx * nz
        bz = tx * ny - ty * nx
        tube = 0.55 * (1.0 + 0.35 * np.sin(7 * tu) * np.sin(3 * tv))
        pts = np.stack([
            cx + tube * (np.cos(tv) * nx + np.sin(tv) * bx),
            cy + tube * (np.cos(tv) * ny + np.sin(tv) * by),
            cz + tube * (np.cos(tv) * nz + np.sin(tv) * bz)], axis=1)
        pts += 0.04 * np.stack([
            _fbm(pts * 0.9, 3, seed=21), _fbm(pts * 0.9, 3, seed=22),
            _fbm(pts * 0.9, 3, seed=23)], axis=1)
        return pts

    verts, f = _ring_mesh(prof, nu, nv, closed_v=True)
    n = _smooth_normals(verts, f)
    mats = [dict(name="jade", kd=(0.35, 0.52, 0.40), ks=(0.12, 0.12, 0.12))]
    write_obj(path, verts, f, np.zeros(len(f), np.int32), mats, normals=n)


def generate_atrium(path: str, detail: float = 1.4) -> None:
    """Sponza-class atrium: colonnade, arches, banners, many lamps.

    detail=1.4 (default) -> ~265k triangles, 14 materials, 48 emissive
    lamps — the Crytek-Sponza workload scale named by BASELINE config 3.
    """
    W, D, H = 24.0, 12.0, 9.0           # hall extents
    verts_all, faces_all, mats_all = [], [], []
    mat_table = [
        dict(name="floor", kd=(0.55, 0.50, 0.45), ks=(0.08, 0.08, 0.08)),
        dict(name="wall", kd=(0.66, 0.60, 0.52)),
        dict(name="ceiling", kd=(0.58, 0.55, 0.50)),
        dict(name="column", kd=(0.72, 0.68, 0.62), ks=(0.03, 0.03, 0.03)),
        dict(name="capital", kd=(0.78, 0.72, 0.60), ks=(0.05, 0.05, 0.05)),
        dict(name="arch", kd=(0.62, 0.57, 0.50)),
        dict(name="trim", kd=(0.45, 0.40, 0.36)),
        dict(name="banner_red", kd=(0.55, 0.08, 0.08)),
        dict(name="banner_green", kd=(0.10, 0.42, 0.12)),
        dict(name="banner_blue", kd=(0.10, 0.15, 0.48)),
        dict(name="lamp_brass", kd=(0.45, 0.35, 0.15), ks=(0.3, 0.25, 0.12)),
        dict(name="lamp_light", kd=(0.0, 0.0, 0.0), ke=(120.0, 95.0, 60.0)),
        dict(name="pool", kd=(0.25, 0.30, 0.35), ks=(0.4, 0.4, 0.4)),
        dict(name="plinth", kd=(0.50, 0.47, 0.44)),
    ]
    mid = {m["name"]: i for i, m in enumerate(mat_table)}

    def add(v, f, m):
        base = sum(len(x) for x in verts_all)
        verts_all.append(np.asarray(v, np.float32))
        faces_all.append(np.asarray(f, np.int32) + base)
        mats_all.append(np.full(len(f), mid[m], np.int32))

    def rect(origin, eu, ev, nu, nv, mat, bump_seed=None, bump=0.0):
        uv, f = _grid(nu, nv)
        v = (np.asarray(origin)[None, :]
             + uv[:, 0:1] * np.asarray(eu)[None, :]
             + uv[:, 1:2] * np.asarray(ev)[None, :])
        if bump_seed is not None:
            nrm = np.cross(eu, ev)
            nrm = nrm / np.linalg.norm(nrm)
            v = v + (bump * _fbm(v * 1.2, 3, bump_seed))[:, None] * nrm[None, :]
        add(v, f, mat)

    d = detail
    gf = max(2, int(72 * d))
    # floor / ceiling
    rect((-W / 2, 0, -D / 2), (W, 0, 0), (0, 0, D), int(gf * 2), gf, "floor",
         bump_seed=31, bump=0.01)
    rect((-W / 2, H, -D / 2), (0, 0, D), (W, 0, 0), gf, int(gf * 2),
         "ceiling")
    wf = max(2, int(40 * d))
    # walls (inward-facing, displaced masonry)
    rect((-W / 2, 0, -D / 2), (W, 0, 0), (0, H, 0), int(wf * 2.4), wf,
         "wall", bump_seed=32, bump=0.05)
    rect((W / 2, 0, D / 2), (-W, 0, 0), (0, H, 0), int(wf * 2.4), wf,
         "wall", bump_seed=33, bump=0.05)
    rect((-W / 2, 0, D / 2), (0, 0, -D), (0, H, 0), int(wf * 1.2), wf,
         "wall", bump_seed=34, bump=0.05)
    rect((W / 2, 0, -D / 2), (0, 0, D), (0, H, 0), int(wf * 1.2), wf,
         "wall", bump_seed=35, bump=0.05)

    # colonnade: two rows, two stories
    ncol = 8
    cs = max(8, int(28 * d))      # circumference segments
    cr = max(6, int(22 * d))      # height rings
    xs = np.linspace(-W / 2 + 2.5, W / 2 - 2.5, ncol)
    story_h = H / 2
    for zrow in (-D / 2 + 2.2, D / 2 - 2.2):
        for story in (0, 1):
            y0 = story * story_h
            for x0 in xs:
                # fluted shaft
                def shaft(u, v, x0=x0, y0=y0):
                    ang = 2 * np.pi * u
                    r = 0.42 * (1.0 + 0.05 * np.cos(12 * ang)) \
                        * (1.0 - 0.12 * v)
                    return np.stack([x0 + r * np.cos(ang),
                                     y0 + 0.35 + v * (story_h - 0.95),
                                     zrow + r * np.sin(ang)], axis=1)
                v_, f_ = _ring_mesh(shaft, cs, cr, closed_v=False)
                add(v_, f_, "column")
                # capital + base (square slabs via small grids)
                for yy, nm in ((y0 + 0.05, "plinth"),
                               (y0 + story_h - 0.45, "capital")):
                    uv, ff = _grid(3, 3)
                    vv = np.stack([x0 - 0.55 + 1.1 * uv[:, 0],
                                   np.full(len(uv), yy),
                                   zrow - 0.55 + 1.1 * uv[:, 1]], axis=1)
                    add(vv, ff, nm)
        # arches between columns (half-tori)
        for i in range(ncol - 1):
            xm = 0.5 * (xs[i] + xs[i + 1])
            span = (xs[i + 1] - xs[i]) / 2

            def arch2(u, v, xm=xm, span=span, zr=zrow):
                th = np.pi * u
                ang = 2 * np.pi * v
                r_t = 0.18
                cx = xm - span * np.cos(th)
                cy = story_h - 0.2 + span * 0.75 * np.sin(th)
                # frame: tangent in xy-plane, normal out-of-plane z
                return np.stack([
                    cx + r_t * np.cos(ang) * np.sin(th) * 0.0
                    + r_t * np.cos(ang) * np.cos(th + np.pi / 2),
                    cy + r_t * np.cos(ang) * np.sin(th + np.pi / 2),
                    zr + r_t * np.sin(ang)], axis=1)
            v_, f_ = _ring_mesh(arch2, max(8, int(20 * d)),
                                max(6, int(12 * d)), closed_v=True)
            add(v_, f_, "arch")

    # banners hanging from the upper gallery
    bf = max(4, int(26 * d))
    colors = ("banner_red", "banner_green", "banner_blue")
    for i, x0 in enumerate(np.linspace(-W / 2 + 3.5, W / 2 - 3.5, 6)):
        for side, zr in ((0, -D / 2 + 2.9), (1, D / 2 - 2.9)):
            uv, ff = _grid(bf, int(bf * 1.5))
            wave = 0.25 * np.sin(3 * np.pi * uv[:, 1] + i) \
                * np.sin(np.pi * uv[:, 0])
            vv = np.stack([
                x0 - 0.8 + 1.6 * uv[:, 0],
                story_h + 1.2 - 2.8 * uv[:, 1],
                zr + wave * (1 if side else -1)], axis=1)
            add(vv, ff, colors[i % 3])

    # central reflecting pool
    rect((-W / 4, 0.12, -D / 8), (W / 2, 0, 0), (0, 0, D / 4),
         max(2, int(30 * d)), max(2, int(15 * d)), "pool")

    # hanging lamps: brass housing (octahedron ring) + emissive core
    lamp_x = np.linspace(-W / 2 + 2.0, W / 2 - 2.0, 8)
    lamp_z = np.linspace(-D / 2 + 1.6, D / 2 - 1.6, 6)
    oct_v = np.array([[0, 1, 0], [1, 0, 0], [0, 0, 1], [-1, 0, 0],
                      [0, 0, -1], [0, -1, 0]], np.float64)
    oct_f = np.array([[0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 1],
                      [5, 2, 1], [5, 3, 2], [5, 4, 3], [5, 1, 4]], np.int32)
    for xi, x0 in enumerate(lamp_x):
        for zi, z0 in enumerate(lamp_z):
            y0 = H - 2.0 - 0.3 * ((xi + zi) % 3)
            add(oct_v * 0.16 + np.array([x0, y0, z0]), oct_f, "lamp_light")
            # housing: slightly larger open ring of panels
            def housing(u, v, x0=x0, y0=y0, z0=z0):
                ang = 2 * np.pi * u
                r = 0.30 - 0.08 * v
                return np.stack([x0 + r * np.cos(ang),
                                 y0 - 0.25 + 0.55 * v,
                                 z0 + r * np.sin(ang)], axis=1)
            v_, f_ = _ring_mesh(housing, 10, 3, closed_v=False)
            add(v_, f_, "lamp_brass")

    verts = np.concatenate(verts_all)
    faces = np.concatenate(faces_all)
    fmat = np.concatenate(mats_all)
    write_obj(path, verts, faces, fmat, mat_table)


_GENERATORS = {
    "sponza_atrium": generate_atrium,
    "bunny": generate_bunny,
    "dragon": generate_dragon,
}


def ensure_asset(name: str, **kw) -> str:
    """Return the OBJ path for a named asset, generating it on first use."""
    if name not in _GENERATORS:
        raise KeyError(f"unknown asset {name!r} (have {sorted(_GENERATORS)})")
    path = os.path.join(asset_dir(), f"{name}.obj")
    if not os.path.exists(path):
        _GENERATORS[name](path, **kw)
    return path
