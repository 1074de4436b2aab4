"""Wavefront-OBJ loader with the reference loader's exact semantics.

Behavioral contract (reference: DXRVoxelizer/XUSG/Optional/XUSGObjLoader.cpp):

- supports ``v``, ``v//vn``, ``v/vt``, ``v/vt/vn`` face formats with polygon
  fan triangulation (XUSGObjLoader.cpp:230-298);
- 1-based indices; negative indices are relative to the number of vertices
  parsed so far (XUSGObjLoader.cpp:243);
- DirectX handedness conversion by default (``for_dx=True``): ``z = -z`` on
  positions and normals plus a reversal of the *entire flat index stream*
  (XUSGObjLoader.cpp:198,213,227);
- per-vertex normal assignment with vertex splitting whenever a face refers to
  a vertex with a normal index different from the first normal assigned to it
  (XUSGObjLoader.cpp:300-335) — note the reference never extends its
  first-normal table for split vertices, so *every* mismatching occurrence
  creates a fresh vertex; we replicate that exactly;
- if the file has no normals, vertex normals are recomputed by accumulating
  the *normalized* face normal of every incident face, then renormalizing
  (XUSGObjLoader.cpp:337-384);
- axis-aligned bounding box over final vertex positions
  (XUSGObjLoader.cpp:386-416).

The implementation is NumPy-vectorized (no per-token Python loop on the hot
path for pure-triangle files, which all canonical scenes are). This is
``dxrvoxelizer_tpu/utils/objloader.py``, copied so the port never imports
JAX; its native C++ tokenizer (utils/native.py, ``_native/objparse.cpp``)
is used when it builds, the Python parser otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class ObjMesh:
    """Loaded mesh. ``positions``/``normals``: float32 [V,3]; ``indices``: int32 [I]."""

    positions: np.ndarray
    normals: np.ndarray
    indices: np.ndarray
    aabb_min: np.ndarray
    aabb_max: np.ndarray

    @property
    def num_vertices(self) -> int:
        return int(self.positions.shape[0])

    @property
    def num_indices(self) -> int:
        return int(self.indices.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.indices.shape[0] // 3)

    @property
    def triangles(self) -> np.ndarray:
        return self.indices.reshape(-1, 3)

    def bound(self) -> np.ndarray:
        """(cx, cy, cz, half_extent) — reference: Content/Voxelizer.cpp:51-57."""
        c = (self.aabb_max + self.aabb_min) * 0.5
        ext = self.aabb_max - self.aabb_min
        return np.array([c[0], c[1], c[2], float(np.max(ext)) * 0.5], dtype=np.float32)


def _parse_float_block(lines: list[str]) -> np.ndarray:
    if not lines:
        return np.zeros((0, 3), dtype=np.float32)
    vals = np.array(" ".join(lines).split(), dtype=np.float32)
    return vals.reshape(len(lines), -1)[:, :3]


def _resolve_indices(raw: np.ndarray, counts_so_far: np.ndarray, total: int) -> np.ndarray:
    """OBJ 1-based / negative-relative index resolution.

    ``raw``: parsed integers; ``counts_so_far``: per-face count of elements
    (vertices/normals/...) parsed before that face line, broadcast to the
    face's corner entries. Reference: XUSGObjLoader.cpp:243.
    """
    neg = raw < 0
    out = np.where(neg, raw + counts_so_far, raw - 1)
    return out.astype(np.int64)


def load_obj(path: str | Path, need_norm: bool = True, need_aabb: bool = True,
             for_dx: bool = True, swap_yz: bool = False,
             impl: str = "auto") -> ObjMesh:
    """Load an OBJ file with reference-equivalent semantics.

    Mirrors ``ObjLoader::Import`` (XUSGObjLoader.cpp:18-40). Normals are always
    returned when ``need_norm``; AABB is always computed when ``need_aabb``.
    ``impl``: "auto" (the native C++ tokenizer when it builds, else
    Python), "native" (raises without it), or "python".
    """
    path = Path(path)
    if impl not in ("auto", "native", "python"):
        raise ValueError(f"unknown OBJ parser impl {impl!r}")
    if impl != "python":
        from dxrvoxelizer_tpu_torch.utils.native import parse_obj_native

        parsed = parse_obj_native(path)
        if parsed is not None:
            positions, file_normals, corner_v, corner_vn = parsed
            has_vn = file_normals.shape[0] > 0
            return _postprocess(
                positions.copy(), file_normals.copy(), corner_v,
                corner_vn if has_vn else None, has_vn,
                need_norm, need_aabb, for_dx, swap_yz,
            )
        if impl == "native":
            raise RuntimeError("native OBJ parser unavailable (g++ missing?)")
    text = path.read_text(errors="replace")
    lines = text.split("\n")

    v_lines: list[str] = []
    vn_lines: list[str] = []
    f_entries: list[tuple[int, str]] = []  # (num v-lines before this face, face body)
    n_v = 0
    n_vn = 0
    vn_before_face: list[int] = []
    for ln in lines:
        s = ln.lstrip()
        if not s:
            continue
        c0 = s[0]
        if c0 == "v":
            if len(s) > 1 and s[1] in " \t":
                v_lines.append(s[2:])
                n_v += 1
            elif s.startswith("vn"):
                vn_lines.append(s[3:])
                n_vn += 1
            # vt lines are counted by the reference but texcoords are never
            # stored (XUSGObjLoader.cpp:160 reserves space, nothing writes it);
            # we skip them entirely.
        elif c0 == "f" and len(s) > 1 and s[1] in " \t":
            f_entries.append((n_v, s[2:]))
            vn_before_face.append(n_vn)

    positions = _parse_float_block(v_lines)
    file_normals = _parse_float_block(vn_lines)

    # ---- faces: vectorized fast path for uniform pure-triangle bodies -------
    has_vn = n_vn > 0
    corner_v: list[np.ndarray] = []
    corner_vn: list[np.ndarray] = []
    corner_vcount: list[np.ndarray] = []
    corner_vncount: list[np.ndarray] = []

    def parse_corner(tok: str) -> tuple[int, int]:
        parts = tok.split("/")
        vi = int(parts[0])
        ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
        return vi, ni

    # Fast path: split all face bodies at once; fall back per-face for fans.
    simple = True
    bodies = [b for _, b in f_entries]
    tok_lists = [b.split() for b in bodies]
    for t in tok_lists:
        if len(t) != 3:
            simple = False
            break

    if simple and f_entries:
        toks = np.array([t for tl in tok_lists for t in tl])
        vbefore = np.repeat(np.array([c for c, _ in f_entries], dtype=np.int64), 3)
        nbefore = np.repeat(np.array(vn_before_face, dtype=np.int64), 3)
        if has_vn:
            # formats: v//vn or v/vt/vn (slashes present)
            split = np.char.partition(toks, "/")
            v_raw = split[:, 0].astype(np.int64)
            rest = np.char.partition(split[:, 2], "/")
            n_raw = rest[:, 2].astype(np.int64)
            corner_v.append(v_raw)
            corner_vn.append(n_raw)
            corner_vcount.append(vbefore)
            corner_vncount.append(nbefore)
        else:
            # plain "v" or "v/vt": take the leading integer
            first = np.char.partition(toks, "/")[:, 0]
            corner_v.append(first.astype(np.int64))
            corner_vcount.append(vbefore)
    else:
        for (vb, _), nb, tl in zip(f_entries, vn_before_face, tok_lists):
            ids = [parse_corner(t) for t in tl]
            # fan triangulation (XUSGObjLoader.cpp:263-297)
            for k in range(1, len(ids) - 1):
                for vi, ni in (ids[0], ids[k], ids[k + 1]):
                    corner_v.append(np.array([vi], dtype=np.int64))
                    corner_vcount.append(np.array([vb], dtype=np.int64))
                    if has_vn:
                        corner_vn.append(np.array([ni], dtype=np.int64))
                        corner_vncount.append(np.array([nb], dtype=np.int64))

    if corner_v:
        v_raw = np.concatenate(corner_v)
        indices = _resolve_indices(v_raw, np.concatenate(corner_vcount), n_v)
    else:
        indices = np.zeros((0,), dtype=np.int64)
    if has_vn and corner_vn:
        n_raw = np.concatenate(corner_vn)
        nrm_indices = _resolve_indices(n_raw, np.concatenate(corner_vncount), n_vn)
    else:
        nrm_indices = None

    return _postprocess(
        positions, file_normals, indices, nrm_indices, has_vn,
        need_norm, need_aabb, for_dx, swap_yz,
    )


def _postprocess(
    positions: np.ndarray,
    file_normals: np.ndarray,
    indices: np.ndarray,
    nrm_indices: np.ndarray | None,
    has_vn: bool,
    need_norm: bool,
    need_aabb: bool,
    for_dx: bool,
    swap_yz: bool,
) -> ObjMesh:
    """Shared post-parse pipeline: DX conversion, normal assignment with
    vertex splitting, winding reversal, normal recompute, AABB."""
    if swap_yz:
        positions = positions[:, [0, 2, 1]].copy()
        if len(file_normals):
            file_normals = file_normals[:, [0, 2, 1]].copy()
    if for_dx:
        positions = positions.copy() if not positions.flags.writeable else positions
        positions[:, 2] *= -1.0
        if len(file_normals):
            file_normals[:, 2] *= -1.0

    indices = np.asarray(indices, dtype=np.int64)
    normals = np.zeros_like(positions)

    if has_vn and nrm_indices is not None and need_norm:
        positions, normals, indices = _assign_normals_with_splitting(
            positions, file_normals, indices, np.asarray(nrm_indices, np.int64)
        )

    # DX winding fix: reverse the entire flat index stream
    # (XUSGObjLoader.cpp:227) — flips winding AND reverses triangle order.
    if (for_dx and not swap_yz) or (not for_dx and swap_yz):
        indices = indices[::-1].copy()

    if need_norm and not has_vn:
        normals = _recompute_normals(positions, indices)

    if need_aabb and len(positions):
        aabb_min = positions.min(axis=0)
        aabb_max = positions.max(axis=0)
    else:
        aabb_min = np.zeros(3, dtype=np.float32)
        aabb_max = np.zeros(3, dtype=np.float32)

    return ObjMesh(
        positions=np.ascontiguousarray(positions, dtype=np.float32),
        normals=np.ascontiguousarray(normals, dtype=np.float32),
        indices=np.ascontiguousarray(indices, dtype=np.int32),
        aabb_min=aabb_min.astype(np.float32),
        aabb_max=aabb_max.astype(np.float32),
    )


def _assign_normals_with_splitting(
    positions: np.ndarray,
    file_normals: np.ndarray,
    indices: np.ndarray,
    nrm_indices: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Replicate ``computePerVertexNormals`` (XUSGObjLoader.cpp:300-335).

    First normal index wins per original vertex; any later corner whose normal
    index differs creates a brand-new vertex (the reference's first-normal
    table is never extended to split vertices, so repeats split again).
    """
    num_v = positions.shape[0]
    # First normal index seen per vertex (stream order).
    first_nrm = np.full(num_v, -1, dtype=np.int64)
    uniq, first_idx = np.unique(indices, return_index=True)
    first_nrm[uniq] = nrm_indices[first_idx]

    mismatch = nrm_indices != first_nrm[indices]
    n_split = int(mismatch.sum())
    new_indices = indices.copy()
    if n_split:
        split_ids = num_v + np.arange(n_split, dtype=np.int64)
        src = indices[mismatch]
        positions = np.concatenate([positions, positions[src]], axis=0)
        new_indices[mismatch] = split_ids

    unit = file_normals / np.maximum(
        np.linalg.norm(file_normals, axis=1, keepdims=True), np.finfo(np.float32).tiny
    )
    normals = np.zeros_like(positions)
    normals[new_indices] = unit[nrm_indices]
    return positions, normals, new_indices


def _recompute_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted face-normal accumulation (XUSGObjLoader.cpp:337-384).

    The reference normalizes each *face* normal before accumulating
    (XUSGObjLoader.cpp:356-359), i.e. equal weight per incident face.
    """
    tris = indices.reshape(-1, 3)
    p0 = positions[tris[:, 0]]
    p1 = positions[tris[:, 1]]
    p2 = positions[tris[:, 2]]
    e1 = p1 - p0
    e2 = p2 - p1
    n = np.cross(e1, e2)
    ln = np.linalg.norm(n, axis=1, keepdims=True)
    n = n / np.maximum(ln, np.finfo(np.float32).tiny)
    out = np.zeros_like(positions)
    np.add.at(out, tris[:, 0], n)
    np.add.at(out, tris[:, 1], n)
    np.add.at(out, tris[:, 2], n)
    lo = np.linalg.norm(out, axis=1, keepdims=True)
    return (out / np.maximum(lo, np.finfo(np.float32).tiny)).astype(np.float32)


def subdivide(mesh: ObjMesh, levels: int = 1) -> ObjMesh:
    """Midpoint 1->4 subdivision (shared edge midpoints deduplicated).

    Each triangle splits into four co-planar children, so the surface —
    and therefore any voxelization of it — is geometrically unchanged
    while the triangle count scales 4x per level. Used to bench the
    hi-poly configs BASELINE.md asks for (the full 871k-tri Stanford
    dragon is not shipped with the reference; its 100k decimation
    subdivided once gives a 400k-tri equivalent workload). Normals are
    averaged per edge (the smooth-shading analog of the reference's
    per-vertex normals, XUSGObjLoader.cpp:300-335).
    """
    pos = mesh.positions
    nrm = mesh.normals
    tris = mesh.indices.reshape(-1, 3).astype(np.int64)
    for _ in range(levels):
        v = pos.shape[0]
        # canonical undirected edge keys -> unique midpoint vertices
        e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
        e = np.sort(e, axis=1)
        key = e[:, 0] * v + e[:, 1]
        uniq, inv = np.unique(key, return_inverse=True)
        ua, ub = uniq // v, uniq % v
        mid_pos = 0.5 * (pos[ua] + pos[ub])
        mn = nrm[ua] + nrm[ub]
        mn = mn / np.maximum(
            np.linalg.norm(mn, axis=1, keepdims=True),
            np.finfo(np.float32).tiny,
        )
        t = tris.shape[0]
        m01 = v + inv[:t]
        m12 = v + inv[t : 2 * t]
        m20 = v + inv[2 * t :]
        pos = np.concatenate([pos, mid_pos.astype(np.float32)])
        nrm = np.concatenate([nrm, mn.astype(np.float32)])
        tris = np.concatenate([
            np.stack([tris[:, 0], m01, m20], axis=1),
            np.stack([m01, tris[:, 1], m12], axis=1),
            np.stack([m20, m12, tris[:, 2]], axis=1),
            np.stack([m01, m12, m20], axis=1),
        ])
    return ObjMesh(
        positions=pos.astype(np.float32),
        normals=nrm.astype(np.float32),
        indices=tris.reshape(-1).astype(np.int32),
        aabb_min=mesh.aabb_min,
        aabb_max=mesh.aabb_max,
    )
