"""On-disk cache of built ray-stab accels (their compact halves).

Port of ``dxrvoxelizer_tpu/utils/accel_cache.py``. The reference builds its
BLAS/TLAS once per geometry at init (Voxelizer.cpp:264-326). A ray-stab
accel's compact half (``raystab_fast.build_raystab_compact2``, gen-6;
``raystab_tiled.build_raystab_compact7``, gen-7) is a pure function of
(geometry bytes, grid size, cubemap ladder, span, deformation pad and
directions) and costs host seconds at 256^3, so it is saved as an .npz keyed
by that tuple's hash and built again only on a miss; the device half
(``assemble_raystab_accel2/7``) runs on every load, with the caller's
normals.

The port's compacts are not the JAX package's (no capacity-class padding;
gen-7 is one CSR of live tiles), so its entries carry their own name prefix
(``pt6_``, ``pt7_``) and format number and it never reads a JAX entry. The
directory is ``DXRVOX_ACCEL_CACHE`` (default ``~/.cache/dxrvoxelizer_tpu/
accel``); the values ``0``, ``off`` and ``none`` turn the cache off, as
``cache_dir=`` does with the same values.
"""

from __future__ import annotations

import hashlib
import json
import os
import zipfile

import numpy as np
import torch

from dxrvoxelizer_tpu_torch.ops import raystab_fast, raystab_tiled

_FORMAT = 1  # bump when a compact's layout or build contract changes
_OFF = ("0", "off", "none")


def default_cache_dir() -> str:
    return os.environ.get(
        "DXRVOX_ACCEL_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "dxrvoxelizer_tpu",
                     "accel"),
    )


def _accel_key(verts_h, tris_h, n: int, gs, span: int, pad: float = 0.0,
               pad_dirs_h=None) -> str:
    h = hashlib.sha256()
    tag = f"fmt{_FORMAT}|n{n}|gs{gs}|span{span}"
    if pad:
        tag += f"|pad{pad!r}"
    if pad_dirs_h is not None:
        tag += "|dirs"
    h.update(tag.encode())
    arrays = (verts_h, tris_h) if pad_dirs_h is None else (
        verts_h, tris_h, pad_dirs_h)
    for a in arrays:
        arr = np.ascontiguousarray(a)
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()[:24]


def _save(path: str, arrays: dict, manifest: dict) -> None:
    arrays = dict(arrays, manifest=np.frombuffer(
        json.dumps({"format": _FORMAT, **manifest}).encode(), dtype=np.uint8))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)  # atomic: readers never see a partial entry


def _load(path: str, kind: str):
    """(arrays, manifest) of an entry of ``kind`` and this format, or None."""
    try:
        with np.load(path) as npz:
            z = {k: npz[k] for k in npz.files}
        manifest = json.loads(bytes(z["manifest"]).decode())
    except (OSError, KeyError, ValueError, zipfile.BadZipFile):
        return None
    if manifest.get("format") != _FORMAT or manifest.get("kind") != kind:
        return None
    return z, manifest


def save_compact2(path: str, compact: raystab_fast.RaystabCompact2) -> None:
    """Serialize a gen-6 compact (.npz, atomic rename)."""
    arrays = {}
    for j, (rt128, tab, bounds) in enumerate(compact.classes):
        arrays[f"C{j}_rt"], arrays[f"C{j}_tab"] = rt128, tab
        if bounds is not None:
            arrays[f"C{j}_bounds"] = bounds
    if compact.ov_ids is not None:
        arrays["OV_ids"] = compact.ov_ids
    _save(path, arrays, {
        "kind": "torch-gen6", "n": compact.n,
        "stats_levels": [list(x) for x in compact.stats.levels],
        "near_origin": compact.stats.near_origin,
        "bounds": [b is not None for _, _, b in compact.classes],
        "ov": compact.ov_ids is not None,
    })


def load_compact2(path: str) -> raystab_fast.RaystabCompact2 | None:
    """A gen-6 compact saved by :func:`save_compact2`, or None when the file
    is absent, unreadable or of another format."""
    got = _load(path, "torch-gen6")
    if got is None:
        return None
    z, m = got
    try:
        classes = tuple(
            (z[f"C{j}_rt"], z[f"C{j}_tab"], z[f"C{j}_bounds"] if b else None)
            for j, b in enumerate(m["bounds"]))
        return raystab_fast.RaystabCompact2(
            n=m["n"], classes=classes,
            ov_ids=z["OV_ids"] if m["ov"] else None,
            stats=raystab_fast.Raystab2Stats(
                levels=tuple(tuple(x) for x in m["stats_levels"]),
                near_origin=m["near_origin"]))
    except (KeyError, TypeError, ValueError):
        return None


def save_compact7(path: str, compact: raystab_tiled.RaystabCompact7) -> None:
    """Serialize a gen-7 compact (.npz, atomic rename)."""
    arrays = {k: getattr(compact, k).cpu().numpy()
              for k in ("tids", "offs", "ids")}
    if compact.bounds is not None:
        arrays["bounds"] = compact.bounds.cpu().numpy()
    st = compact.stats
    _save(path, arrays, {
        "kind": "torch-gen7", "n": compact.n,
        "stats": [st.g_fine, st.live_tiles, st.dead_tiles, st.pairs,
                  st.near_origin],
        "bounds": compact.bounds is not None,
    })


def load_compact7(path: str, device="cpu") -> raystab_tiled.RaystabCompact7 | None:
    """A gen-7 compact saved by :func:`save_compact7`, on ``device``, or
    None when the file is absent, unreadable or of another format."""
    got = _load(path, "torch-gen7")
    if got is None:
        return None
    z, m = got
    try:
        t = {k: torch.from_numpy(z[k]).to(device) for k in ("tids", "offs", "ids")}
        bounds = torch.from_numpy(z["bounds"]).to(device) if m["bounds"] else None
        return raystab_tiled.RaystabCompact7(
            n=m["n"], bounds=bounds,
            stats=raystab_tiled.Raystab7Stats(*m["stats"]), **t)
    except (KeyError, TypeError, ValueError):
        return None


def _entry(verts_norm, tris, n, gs, span, pad, pad_dirs, cache_dir, prefix):
    """(cache path or None when the cache is off, host pad_dirs or None)."""
    dirs_h = None if pad_dirs is None else raystab_fast._host_f32(pad_dirs)
    root = cache_dir or default_cache_dir()
    if str(root) in _OFF:
        return None, dirs_h
    key = _accel_key(raystab_fast._host_f32(verts_norm),
                     raystab_fast._host(tris), n, gs, span, pad, dirs_h)
    return os.path.join(root, f"{prefix}{key}.npz"), dirs_h


def cached_compact2(verts_norm, tris, n: int = 64, gs=None, pad: float = 0.0,
                    cache_dir: str | None = None, pad_dirs=None):
    """``build_raystab_compact2`` behind the on-disk cache. The key hashes
    the geometry's bytes, n, gs, the span, the pad and the pad directions
    (the normals do not shape the compact); a miss builds and saves."""
    path, dirs_h = _entry(verts_norm, tris, n, gs, raystab_fast.SPAN, pad,
                          pad_dirs, cache_dir, "pt6_")
    compact = None if path is None else load_compact2(path)
    if compact is None:
        compact = raystab_fast.build_raystab_compact2(verts_norm, tris, n, gs,
                                                      pad, dirs_h)
        if path is not None:
            try:
                save_compact2(path, compact)
            except OSError:
                pass  # a read-only cache: serve the built compact anyway
    return compact


def cached_compact7(verts_norm, tris, n: int = 64, gs=None, pad: float = 0.0,
                    cache_dir: str | None = None, pad_dirs=None):
    """``build_raystab_compact7`` behind the on-disk cache (the key scheme
    of :func:`cached_compact2`); the compact lands on ``verts_norm``'s
    device."""
    path, dirs_h = _entry(verts_norm, tris, n, gs, raystab_fast.SPAN, pad,
                          pad_dirs, cache_dir, "pt7_")
    device = (verts_norm.device if isinstance(verts_norm, torch.Tensor)
              else "cpu")
    compact = None if path is None else load_compact7(path, device)
    if compact is None:
        compact = raystab_tiled.build_raystab_compact7(verts_norm, tris, n, gs,
                                                       pad, dirs_h)
        if path is not None:
            try:
                save_compact7(path, compact)
            except OSError:
                pass
    return compact


def cached_build_raystab_accel2(verts_norm, tris, normals, n: int = 64, gs=None,
                                cache_dir: str | None = None):
    """``build_raystab_accel2`` behind the on-disk compact cache."""
    compact = cached_compact2(verts_norm, tris, n, gs, cache_dir=cache_dir)
    return raystab_fast.assemble_raystab_accel2(compact, verts_norm, tris, normals)


def cached_build_raystab_accel7(verts_norm, tris, normals, n: int = 64, gs=None,
                                cache_dir: str | None = None):
    """``build_raystab_accel7`` behind the on-disk compact cache."""
    compact = cached_compact7(verts_norm, tris, n, gs, cache_dir=cache_dir)
    return raystab_tiled.assemble_raystab_accel7(compact, verts_norm, tris,
                                                 normals)
