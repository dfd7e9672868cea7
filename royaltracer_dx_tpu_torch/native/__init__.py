"""The native OBJ geometry parser (host code, C, bound with ctypes).

``objparse.c`` is a byte-for-byte copy of the JAX package's parser
(royaltracer_dx_tpu/native/objparse.c).  It is built on first use with the
system C compiler into ``royaltracer_dx_tpu_torch/_build/`` (git-ignored),
under a name keyed by the hash of the source, and loaded with ctypes.  It
is host code, not a GPU kernel: the loader (scene/obj_loader.py) keeps the
pure-Python parser beside it and reports which of the two ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "objparse.c")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
_LIB = None
_TRIED = False


class _ObjResult(ctypes.Structure):
    _fields_ = [
        ("verts", ctypes.POINTER(ctypes.c_float)),
        ("n_verts", ctypes.c_int64),
        ("indices", ctypes.POINTER(ctypes.c_int32)),
        ("tri_slot", ctypes.POINTER(ctypes.c_int32)),
        ("n_tris", ctypes.c_int64),
        ("stmts", ctypes.POINTER(ctypes.c_char)),
        ("stmts_len", ctypes.c_int64),
        ("error", ctypes.c_int32),
    ]


def build() -> str | None:
    """Compile objparse.c into _build/ (once per source hash); returns the
    library path, or None when no C compiler is available."""
    with open(_SRC, "rb") as f:
        key = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(_BUILD_DIR, f"objparse_{key}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    for cc in ("cc", "gcc", "clang"):
        try:
            subprocess.run([cc, "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
                           check=True, capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            continue
        os.replace(tmp, out)
        return out
    return None


def _lib():
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        path = build()
        if path is not None:
            lib = ctypes.CDLL(path)
            lib.obj_parse.restype = ctypes.POINTER(_ObjResult)
            lib.obj_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64]
            lib.obj_free.restype = None
            lib.obj_free.argtypes = [ctypes.POINTER(_ObjResult)]
            _LIB = lib
    return _LIB


def parse_obj_geometry(path: str):
    """Parse OBJ geometry natively (native/__init__.py:94-121 of the JAX
    package).  Returns (verts [V, 6] position|normal float32, indices
    [T, 3] int32, tri_slot [T] int32 usemtl ordinal per triangle,
    statement lines: the mtllib/usemtl lines in file order), or None when
    the parser cannot be built or reports an error."""
    lib = _lib()
    if lib is None:
        return None
    with open(path, "rb") as fh:
        data = fh.read()
    res = lib.obj_parse(data, len(data))
    if not res:
        return None
    try:
        r = res.contents
        if r.error != 0:
            return None
        nv, nt = int(r.n_verts), int(r.n_tris)
        verts = (np.ctypeslib.as_array(r.verts, shape=(nv, 6)).copy()
                 if nv else np.zeros((0, 6), np.float32))
        indices = (np.ctypeslib.as_array(r.indices, shape=(nt, 3)).copy()
                   if nt else np.zeros((0, 3), np.int32))
        tri_slot = (np.ctypeslib.as_array(r.tri_slot, shape=(nt,)).copy()
                    if nt else np.zeros((0,), np.int32))
        stmts = ctypes.string_at(r.stmts, r.stmts_len).decode(
            "utf-8", errors="replace")
        lines = [ln for ln in stmts.split("\n") if ln.strip()]
        return verts, indices, tri_slot, lines
    finally:
        lib.obj_free(res)
