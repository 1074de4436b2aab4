"""ctypes bindings and build-at-first-use of the native (C++) host tier.

Port of ``dxrvoxelizer_tpu/utils/native.py`` (the reference ships its
runtime as C++ DLLs, SURVEY.md section 2b), with the port's own copies of
the sources in ``utils/_native/``:

- ``objparse.cpp``: the OBJ tokenizer (the XUSGObjLoader analog), for
  ``utils/objloader.load_obj``;
- ``pngwrite.cpp``: the PNG encoder (the stb_image_write analog, needs
  zlib), for ``utils/image.write_png``;
- ``accelpack.cpp``: the gen-6 accel build's strip-packing walk and ray
  table (ops/raystab_fast.py), bit-identical to their Python versions.

Each library is compiled by ``g++`` at its first use into
``dxrvoxelizer_tpu_torch/_build/`` (listed in ``.gitignore``), named by a
hash of its source and flags, and loaded with ``ctypes``; nothing is built
when the module is imported. Where ``g++`` (or zlib) is missing, the
functions return None (False for the PNG writer) and their callers run the
Python versions. These are host code paths, not device kernels.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent / "_native"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# -ffp-contract=off: the accel passes round as numpy's float32 does
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")
_LIBS = {"objparse": (), "pngwrite": ("-lz",), "accelpack": ()}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
# (restype, argtypes) of every entry point, by library
_SIGNATURES = {
    "objparse": {
        "objparse_load": (_P, (ctypes.c_char_p,)),
        "objparse_num_vertices": (_I64, (_P,)),
        "objparse_num_normals": (_I64, (_P,)),
        "objparse_num_corners": (_I64, (_P,)),
        "objparse_copy_positions": (None, (_P, _P)),
        "objparse_copy_normals": (None, (_P, _P)),
        "objparse_copy_corners": (None, (_P, _P, _P)),
        "objparse_free": (None, (_P,)),
    },
    "pngwrite": {
        "pngwrite_file": (ctypes.c_int, (ctypes.c_char_p, _P, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int)),
    },
    "accelpack": {
        # cell_offs, cell_data, n_cells, ray_table, r_cap, rc, tri_bounds
        "accelpack_run": (_P, (_P, _P, _I64, _P, _I64, _P, _P)),
        "accelpack_n_packs": (_I64, (_P,)),
        "accelpack_ray_total": (_I64, (_P,)),
        "accelpack_id_total": (_I64, (_P,)),
        "accelpack_copy": (None, (_P, _P, _P, _P, _P)),
        "accelpack_free": (None, (_P,)),
        "accelpack_dir_cells": (None, (_I64, _I64, _P)),
        "accelpack_raytab_start": (_P, (_I64, _I64)),
        "accelpack_raytab_rcap": (_I64, (_P,)),
        "accelpack_raytab_counts": (None, (_P, _P)),
        "accelpack_raytab_fill": (None, (_P, _I64, _P)),
        "accelpack_raytab_free": (None, (_P,)),
    },
}


@dataclass
class NativeBuild:
    path: Path
    seconds: float  # 0.0 when the library was already built


@functools.cache
def build(name: str) -> NativeBuild | None:
    """Compile ``_native/<name>.cpp`` unless already built -> the library,
    or None when the compiler (or a library it links) is missing."""
    src = _NATIVE_DIR / f"{name}.cpp"
    extra = _LIBS[name]
    h = hashlib.sha256(" ".join(CXX_FLAGS + extra).encode() + src.read_bytes())
    out = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    if out.is_file():
        return NativeBuild(out, 0.0)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # build under a temporary name and rename: concurrent builds never load
    # a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as td:
        tmp = Path(td) / out.name
        try:
            subprocess.run(["g++", *CXX_FLAGS, str(src), "-o", str(tmp), *extra],
                           check=True, capture_output=True, timeout=300)
        except (OSError, subprocess.SubprocessError):
            return None
        os.replace(tmp, out)
    return NativeBuild(out, time.perf_counter() - t0)


@functools.cache
def _load(name: str) -> ctypes.CDLL | None:
    info = build(name)
    if info is None:
        return None
    try:
        lib = ctypes.CDLL(str(info.path))
    except OSError:
        return None
    for fn_name, (restype, argtypes) in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.restype = restype
        fn.argtypes = list(argtypes)
    return lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def parse_obj_native(path: str | Path):
    """Parse an OBJ with the native tokenizer -> (positions [V,3] f32,
    normals [VN,3] f32, corner_v [I] i64, corner_vn [I] i64 with -1 for "no
    normal"), or None when the library is unavailable."""
    lib = _load("objparse")
    if lib is None:
        return None
    h = lib.objparse_load(str(path).encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        nv = lib.objparse_num_vertices(h)
        nn = lib.objparse_num_normals(h)
        nc = lib.objparse_num_corners(h)
        pos = np.empty((nv, 3), dtype=np.float32)
        nrm = np.empty((nn, 3), dtype=np.float32)
        cv = np.empty(nc, dtype=np.int64)
        cn = np.empty(nc, dtype=np.int64)
        if nv:
            lib.objparse_copy_positions(h, _ptr(pos))
        if nn:
            lib.objparse_copy_normals(h, _ptr(nrm))
        if nc:
            lib.objparse_copy_corners(h, _ptr(cv), _ptr(cn))
        return pos, nrm, cv, cn
    finally:
        lib.objparse_free(h)


def write_png_native(path, img: np.ndarray) -> bool:
    """Encode and write an image with the native encoder. ``img``: uint8
    [H, W, C]. False (the caller writes it in Python) when the library is
    unavailable."""
    lib = _load("pngwrite")
    if lib is None:
        return False
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, ch = img.shape
    rc = lib.pngwrite_file(str(path).encode(), _ptr(img), w, h, ch)
    if rc != 0:
        raise OSError(f"native png write failed: rc={rc} path={path}")
    return True


def accel_pack_native(cell_offs, cell_data, ray_table, rc, tri_bounds):
    """The gen-6 strip-packing walk in C++ -> (ray_data i32, ray_offs i64,
    id_data i64, id_offs i64), bit-identical to
    ``ops/raystab_fast._make_packs_py`` on the same inputs, or None when the
    library is unavailable."""
    lib = _load("accelpack")
    if lib is None:
        return None
    cell_offs = np.ascontiguousarray(cell_offs, np.int64)
    cell_data = np.ascontiguousarray(cell_data, np.int64)
    ray_table = np.ascontiguousarray(ray_table, np.int32)
    rc = np.ascontiguousarray(rc, np.int64)
    n_cells = cell_offs.shape[0] - 1
    if ray_table.shape[0] != n_cells or rc.shape[0] != n_cells:
        raise ValueError(f"{n_cells} cells, but a ray table of "
                         f"{ray_table.shape[0]} rows and {rc.shape[0]} counts")
    if tri_bounds is not None:
        tri_bounds = np.ascontiguousarray(tri_bounds, np.float64)
        max_id = int(cell_data.max()) if cell_data.size else 0
        if tri_bounds.shape[0] <= max_id:
            raise ValueError(f"tri_bounds has {tri_bounds.shape[0]} entries, "
                             f"candidate id {max_id} needs more")
    h = lib.accelpack_run(
        _ptr(cell_offs), _ptr(cell_data), n_cells, _ptr(ray_table),
        ray_table.shape[1], _ptr(rc),
        None if tri_bounds is None else _ptr(tri_bounds))
    if not h:
        raise MemoryError("accelpack_run: out of memory")
    try:
        n_packs = lib.accelpack_n_packs(h)
        ray_data = np.empty((lib.accelpack_ray_total(h),), np.int32)
        id_data = np.empty((lib.accelpack_id_total(h),), np.int64)
        ray_offs = np.empty((n_packs + 1,), np.int64)
        id_offs = np.empty((n_packs + 1,), np.int64)
        lib.accelpack_copy(h, _ptr(ray_data), _ptr(ray_offs), _ptr(id_data),
                           _ptr(id_offs))
    finally:
        lib.accelpack_free(h)
    return ray_data, ray_offs, id_data, id_offs


def raytab_native(n: int, g: int):
    """The voxel -> direction-cell ray table in C++: (ray_table [C, r_cap]
    i32 voxel ids / -1, rc [C] i64 rays per cell), each cell's rays ordered
    by (origin radius, voxel id); bit-identical to
    ``ops/raystab_fast._ray_table_filled_py``. None when the library is
    unavailable."""
    lib = _load("accelpack")
    if lib is None:
        return None
    h = lib.accelpack_raytab_start(n, g)
    if not h:
        raise MemoryError("accelpack_raytab_start: out of memory")
    try:
        r_cap = int(lib.accelpack_raytab_rcap(h))
        rc = np.empty((6 * g * g,), np.int64)
        lib.accelpack_raytab_counts(h, _ptr(rc))
        rt = np.empty((6 * g * g, r_cap), np.int32)
        lib.accelpack_raytab_fill(h, r_cap, _ptr(rt))
    finally:
        lib.accelpack_raytab_free(h)
    return rt, rc


def dir_cells_native(n: int, g: int):
    """Every voxel centre's cubemap cell id [n^3] int64 (x-major), fused
    with the centre generation; bit-identical to
    ``ops/raystab_fast._dir_cells_host`` over the grid's voxel centres. None
    when the library is unavailable."""
    lib = _load("accelpack")
    if lib is None:
        return None
    out = np.empty((n * n * n,), np.int64)
    lib.accelpack_dir_cells(n, g, _ptr(out))
    return out
