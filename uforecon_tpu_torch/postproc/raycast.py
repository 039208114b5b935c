"""Ray-mesh first hits through the repository's native BVH (``native/bvh.cpp``).

Counterpart of the JAX package's ``postproc/raycast.py`` (the Embree
replacement of the reference's frustum filter, reference
evaluation/clean_mesh.py:216 ``intersects_first``): a median-split BVH with
Moller-Trumbore tests, OpenMP over rays, bound with ctypes. The library is
compiled at first use with the compiler and flags of ``native/Makefile``
into the git-ignored ``uforecon_tpu_torch/_build/``, keyed by the source
and flags (without ``-fopenmp`` where the compiler has no OpenMP: the same
code on one thread, with a warning). A failed build or load raises; there
is no fallback to another algorithm.
``intersects_first_numpy`` (vectorised Moller-Trumbore over all
triangles, O(rays x triangles)) is the plain version the tests hold the
library against.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import subprocess
import tempfile
import warnings
from pathlib import Path
from typing import Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
NATIVE = _PKG.parent / "native"
BUILD_DIR = _PKG / "_build"


def _make_var(makefile: str, name: str) -> str:
    m = re.search(rf"^{name}\s*\??=\s*(.*)$", makefile, re.M)
    if m is None:
        raise RuntimeError(f"native/Makefile sets no {name}")
    return m.group(1).strip()


def _compile(cxx: str, flags, src: Path, out: Path) -> str:
    """Compile ``src`` into ``out`` (atomically: concurrent builds are
    safe); returns the compiler's errors, empty on success."""
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        res = subprocess.run([cxx, *flags, str(src), "-o", tmp],
                             capture_output=True, text=True, timeout=300)
        if res.returncode == 0:
            os.replace(tmp, out)
            return ""
        return res.stderr[-4000:] or f"exit {res.returncode}"
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The BVH library, built on first call (``CXX`` / ``CXXFLAGS`` of the
    environment override the Makefile's defaults, as ``make`` would). A
    compiler without OpenMP builds it without ``-fopenmp``: the same
    traversal, on one thread."""
    src = NATIVE / "bvh.cpp"
    if not src.exists():
        raise FileNotFoundError(f"{src} is missing: the BVH library is built from "
                                "the repository's native/ sources")
    makefile = (NATIVE / "Makefile").read_text()
    cxx = os.environ.get("CXX") or _make_var(makefile, "CXX")
    flags = (os.environ.get("CXXFLAGS") or _make_var(makefile, "CXXFLAGS")).split()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    attempts = [flags]
    if "-fopenmp" in flags:
        attempts.append([f for f in flags if f != "-fopenmp"])
    errors = []
    for fl in attempts:
        key = hashlib.sha256(src.read_bytes() + " ".join([cxx] + fl).encode())
        out = BUILD_DIR / f"libuforecon_bvh-{key.hexdigest()[:16]}.so"
        if out.exists():
            break
        err = _compile(cxx, fl, src, out)
        if not err:
            break
        errors.append(f"{cxx} {' '.join(fl)}:\n{err}")
    else:
        raise RuntimeError("building the BVH library failed:\n" + "\n".join(errors))
    if errors:
        warnings.warn(f"the BVH library is built without OpenMP and runs on one "
                      f"thread: {errors[0][-300:]}", stacklevel=2)
    lib = ctypes.CDLL(str(out))
    lib.bvh_build.restype = ctypes.c_void_p
    lib.bvh_build.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                              ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
    lib.bvh_free.restype = None
    lib.bvh_free.argtypes = [ctypes.c_void_p]
    lib.bvh_intersect_first.restype = None
    lib.bvh_intersect_first.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)]
    return lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _rays(origins, dirs) -> Tuple[np.ndarray, np.ndarray]:
    origins = np.ascontiguousarray(origins, np.float32)
    dirs = np.ascontiguousarray(dirs, np.float32)
    if origins.ndim != 2 or origins.shape[1] != 3 or dirs.shape != origins.shape:
        raise ValueError(f"origins and dirs must both be (N, 3), got "
                         f"{origins.shape} and {dirs.shape}")
    return origins, dirs


class RayMeshIntersector:
    """First-hit ray queries against a triangle mesh, through the BVH."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray):
        self.vertices = np.ascontiguousarray(vertices, np.float32)
        self.faces = np.ascontiguousarray(faces, np.int32)
        if self.vertices.ndim != 2 or self.vertices.shape[1] != 3:
            raise ValueError(f"vertices must be (N, 3), got {self.vertices.shape}")
        if self.faces.ndim != 2 or self.faces.shape[1] != 3:
            raise ValueError(f"faces must be (M, 3), got {self.faces.shape}")
        if self.faces.size and (self.faces.min() < 0
                                or self.faces.max() >= len(self.vertices)):
            raise ValueError("a face indexes a vertex outside the mesh")
        self._lib = library()
        self._handle = ctypes.c_void_p(self._lib.bvh_build(
            _ptr(self.vertices, ctypes.c_float), len(self.vertices),
            _ptr(self.faces, ctypes.c_int32), len(self.faces)))

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.bvh_free(self._handle)
            self._handle = None

    def intersects_first(self, origins: np.ndarray, dirs: np.ndarray
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Per ray: (triangle index or -1, hit distance or -1)."""
        origins, dirs = _rays(origins, dirs)
        n = len(origins)
        out_tri = np.empty(n, np.int32)
        out_t = np.empty(n, np.float32)
        self._lib.bvh_intersect_first(
            self._handle, _ptr(origins, ctypes.c_float), _ptr(dirs, ctypes.c_float),
            n, _ptr(out_tri, ctypes.c_int32), _ptr(out_t, ctypes.c_float))
        return out_tri, out_t


def intersects_first_numpy(vertices: np.ndarray, faces: np.ndarray,
                           origins: np.ndarray, dirs: np.ndarray,
                           chunk: int = 2048) -> Tuple[np.ndarray, np.ndarray]:
    """The plain version of ``RayMeshIntersector.intersects_first``: the
    JAX package's vectorised Moller-Trumbore over every triangle."""
    origins, dirs = _rays(origins, dirs)
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces)
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]          # (T, 3)
    e1, e2 = p1 - p0, p2 - p0
    n = len(origins)
    out_tri = np.full(n, -1, np.int32)
    out_t = np.full(n, -1.0, np.float32)
    for s in range(0, n, chunk):
        o = origins[s:s + chunk, None]                        # (R, 1, 3)
        d = dirs[s:s + chunk, None]
        pv = np.cross(d, e2[None])                            # (R, T, 3)
        det = np.sum(e1[None] * pv, -1)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = np.where(np.abs(det) > 1e-12, 1.0 / det, 0.0)
            tv = o - p0[None]
            u = np.sum(tv * pv, -1) * inv
            qv = np.cross(tv, e1[None])
            w = np.sum(d * qv, -1) * inv
            t = np.sum(e2[None] * qv, -1) * inv
        ok = ((np.abs(det) > 1e-12) & (u >= -1e-6) & (w >= -1e-6)
              & (u + w <= 1 + 1e-6) & (t >= 0))
        t = np.where(ok, t, np.inf)
        best = np.argmin(t, axis=1)
        bt = t[np.arange(len(best)), best]
        hit = np.isfinite(bt)
        out_tri[s:s + chunk][hit] = best[hit].astype(np.int32)
        out_t[s:s + chunk][hit] = bt[hit].astype(np.float32)
    return out_tri, out_t
