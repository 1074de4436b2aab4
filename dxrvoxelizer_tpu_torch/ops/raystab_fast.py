"""Ray-stab voxelizer accelerated by direction-space binning (gen-1, gen-6).

Port of the gen-1 and gen-6 paths of ``dxrvoxelizer_tpu/ops/raystab_fast.py``.
The reference launches one ray per voxel from the voxel centre radially
outward and marks the voxel inside iff the first hit is back-facing
(DXRVoxelizer.hlsl:44-53, 132-140). Every ray lies on a line through the
grid origin, so a triangle can only be hit by rays whose direction falls in
the cone it subtends from the origin: triangles are binned into cubemaps
over direction space (the TLAS analog) and each voxel ray is tested against
its direction cell's candidates.

Gen-1 (:func:`build_raystab_accel`, :func:`raystab_query`): one cubemap
level; triangles whose cone spans more than ``span`` cells, or whose
bounding ball nears the origin, overflow to a list every ray is tested
against. Each direction cell's rays are tested with the Moller-Trumbore rule
(ops/raystab_mt_cuda.py), then the winner's normal is finished; ground truth
is the Moller-Trumbore oracle. The JAX package runs it for every ray-stab
call on the CPU, and so does the port, at every grid size. The TPU's
capacity classes, 128-lane ray blocks and cell padding are not carried
over: the accel is a list of slices of at most 128 rays of one cell, each
with its cell's range of candidate rows.

Gen-6 (n < 128 on a GPU), a ladder of cubemap levels, voxel rays grouped by
direction cell into strips of 128, each strip tested against the union of
its cells' candidates with the radial rule:

- Host half (numpy, copied from the JAX package): the static voxel->cell ray
  table, the cone binning (``_cone_keys_np``, with the deformation pad of
  the refitter, ops/raystab_refit.py), the ladder fold, the greedy strip
  packing and the capacity classes with their per-256-candidate chunk-skip
  bounds -> :class:`RaystabCompact2`.
- Device half (torch gathers): :func:`assemble_raystab_accel2` lays every
  class's strips out as ONE strip stream (rays, per-strip candidate offset
  and count, the candidates' coefficient + normal rows, chunk bounds), so
  the query is one kernel launch (ops/raystab_cuda.py), plus a second one
  for the near-origin triangles that every ray is tested against.
- The query (:func:`raystab_query2`) writes each slot's finished rgba into
  ray order through the slot->ray index: the strips partition the rays, so
  this is a scatter (the JAX package sorts instead because TPU scatters are
  slow). Rays no strip covers get zeros; the near-origin stream merges by
  the same (t, lowest id) rule.

The TPU's layout machinery is not carried over: no lane-aligned second
table layout, no strips-per-step row padding, no on-disk ray-table cache.
Ground truth is the radial oracle (ops/voxelize_ref.py).

:func:`voxelize_raystab_fast` routes as the JAX package does: gen-1 on the
CPU, gen-6 on a GPU below 128^3 and gen-7 (ops/raystab_tiled.py) above.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from dxrvoxelizer_tpu_torch.ops import (
    _cuda,
    grid_cuda,
    intersect,
    raystab_cuda,
    raystab_mt_cuda,
)
from dxrvoxelizer_tpu_torch.ops.packing import voxel_centers_norm
from dxrvoxelizer_tpu_torch.ops.raystab_cuda import K_BLOCK, StripTables
from dxrvoxelizer_tpu_torch.ops.raystab_mt_cuda import LANES, MTTables, slice_stream

INSIDE_THRESHOLD = 0.12  # DXRVoxelizer.hlsl:5

# face f: axis a = f >> 1, sign s = +1 for even f; (b, c) = other axes asc.
_OTHERS = np.array([[1, 2], [0, 2], [0, 1]], dtype=np.int32)

# capacity classes: k <= 256 a multiple of 8, k > 256 a multiple of the
# 256-candidate chunk the skip bounds are defined over
CLASS_CAPS2 = (
    16, 24, 32, 48, 64, 96, 128, 192, 256, 512, 768, 1024, 1536,
    2048, 3072, 4096, 6144, 8192,
)
LEVELS2 = (32, 8)  # cubemap sizes, fine -> coarse
SPAN = 8  # cells per axis a triangle's rectangle may span at its level


def default_gs(n: int) -> tuple:
    """Default cubemap ladder by grid size: hi-res grids get finer top
    levels so rays-per-cell stays near one 128-lane strip."""
    if n >= 256:
        return (128, 32, 8)
    if n >= 128:
        return (64, 16, 8)
    return LEVELS2


def _host(x) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array."""
    return np.asarray(torch.as_tensor(x).cpu().numpy())


def _host_f32(x) -> np.ndarray:
    return np.asarray(_host(x), np.float32)


def _pow2cap(max_bin: int) -> int:
    cap = 8
    while cap < max_bin:
        cap *= 2
    return cap


@dataclass
class Raystab2Stats:
    levels: tuple  # per level: (g, live_cells, capacity, max_bin, strips)
    near_origin: int  # triangles tested against every ray


def _dir_cells_host(d: np.ndarray, g: int) -> np.ndarray:
    """Direction [V,3] -> cubemap cell id [V]. Scale-invariant
    (u = d_b / |d_a|), so raw voxel centres serve as directions; a boundary
    ray landing one cell over is safe (the cone binning pads every rectangle
    by a 1e-4 rad guard)."""
    d = np.asarray(d, np.float32)
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    ax, ay, az = np.abs(x), np.abs(y), np.abs(z)
    # np.argmax's first-max tie rule, branchless
    a = np.where(ax >= ay, np.where(ax >= az, 0, 2),
                 np.where(ay >= az, 1, 2)).astype(np.int8)
    da = np.where(a == 0, x, np.where(a == 1, y, z))
    db = np.where(a == 0, y, x)  # _OTHERS[a, 0]
    dc = np.where(a == 2, y, z)  # _OTHERS[a, 1]
    f = 2 * a.astype(np.int64) + (da < 0)
    ada = np.abs(da)
    iu = np.clip(((db / ada + 1.0) * (0.5 * g)).astype(np.int64), 0, g - 1)
    iv = np.clip(((dc / ada + 1.0) * (0.5 * g)).astype(np.int64), 0, g - 1)
    return f * (g * g) + iu * g + iv


def _raytab_fill(order: np.ndarray, starts: np.ndarray,
                 n_cells: int) -> np.ndarray:
    """(order, starts) -> ray_table [C, R_cap] (voxel ids, -1 padding),
    filled in row chunks that bound the index temporaries."""
    counts = (starts[1:] - starts[:-1]).astype(np.int64)
    r_cap = max(int(-(-counts.max() // 8) * 8), 8) if counts.size else 8
    ray_table = np.empty((n_cells, r_cap), dtype=np.int32)
    j = np.arange(r_cap, dtype=np.int64)[None, :]
    hi = max(order.shape[0] - 1, 0)
    step = max(1, (1 << 24) // r_cap)
    for lo in range(0, n_cells, step):
        sl = slice(lo, min(lo + step, n_cells))
        in_run = j < counts[sl, None]
        run_idx = np.clip(starts[sl][:, None] + j, 0, hi)
        ray_table[sl] = np.where(in_run, order[run_idx], -1)
    return ray_table


@functools.lru_cache(maxsize=8)
def _ray_table_filled(n: int, g: int):
    """Static voxel->cell grouping (kept in memory): (ray_table [C, R_cap]
    int32 voxel ids / -1, rc [C] int64 per-cell ray counts). Within every
    cell the rays ascend by (origin-radius f32 bits, voxel id), so the pack
    walk cuts big cells into radius-banded strips directly. Built by the
    native tier (utils/native.raytab_native, two linear passes) when it
    builds, else by :func:`_ray_table_filled_py`; the two are equal bit
    for bit."""
    from dxrvoxelizer_tpu_torch.utils import native

    nat = native.raytab_native(n, g)
    return nat if nat is not None else _ray_table_filled_py(n, g)


def _ray_table_filled_py(n: int, g: int):
    """:func:`_ray_table_filled` in numpy (argsorts over every voxel)."""
    n_cells = 6 * g * g
    v = n * n * n
    cx, cy, cz = voxel_centers_norm(n)
    pos = np.stack(
        np.meshgrid(cx, cy, cz, indexing="ij"), axis=-1
    ).reshape(-1, 3).astype(np.float32)
    cells = _dir_cells_host(pos, g)
    r = np.sqrt((pos * pos).sum(-1, dtype=np.float32))
    skey = (
        r.view(np.uint32).astype(np.uint64) << np.uint64(32)
    ) | np.arange(v, dtype=np.uint64)
    perm1 = np.argsort(skey)
    order = perm1[np.argsort(cells[perm1], kind="stable")].astype(np.int32)
    sorted_cells = np.sort(cells)
    starts = np.searchsorted(sorted_cells, np.arange(n_cells + 1)).astype(
        np.int64
    )
    rt = _raytab_fill(order, starts, n_cells)
    rc = (starts[1:] - starts[:-1]).astype(np.int64)
    return rt, rc


def voxel_rays(n: int, device: torch.device | str = "cpu"):
    """Per-voxel ray origins + directions [V,3], the oracle's expressions:
    origin = voxel centre, direction = centre / max(|centre|, 1e-20), with
    the norm spelled ((x*x + y*y) + z*z)."""
    cx, cy, cz = voxel_centers_norm(n)
    pos = torch.from_numpy(
        np.stack(np.meshgrid(cx, cy, cz, indexing="ij"), axis=-1).reshape(-1, 3)
    ).to(device)
    length = _norm3(pos)
    return pos, pos / torch.clamp(length, min=1e-20)[:, None]


def _norm3(p: torch.Tensor) -> torch.Tensor:
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return intersect.sqrt_rn((x * x + y * y) + z * z)


def _ray_params(n: int, device: torch.device | str = "cpu"):
    """Per-voxel (dirs [V,3], s0 [V]) so that t = c/den - s0 matches the
    radial oracle bit for bit."""
    pos, dirs = voxel_rays(n, device)
    return dirs, _norm3(pos)


def _capsule_params(verts_h, tris_h, pad: float, pad_dirs):
    """Per-triangle capsule endpoints and extra radius for a directional
    deformation bound.

    Contract: every frame's vertices are v'_i = v_i + s_i * d_i with
    |s_i| <= pad and d_i = pad_dirs[i]. With the triangle's mean direction
    a = (d_0 + d_1 + d_2)/3, v_i + s_i d_i = (v_i + s_i a) + s_i (d_i - a),
    so every deformed point lies in the hull of two balls at c +- pad*a of
    radius r + pad * max_i |d_i - a|. Returns (offs [T,3] f32 = pad*a,
    r_extra [T] f32 = pad*maxdev)."""
    d0 = pad_dirs[tris_h[:, 0]].astype(np.float32)
    d1 = pad_dirs[tris_h[:, 1]].astype(np.float32)
    d2 = pad_dirs[tris_h[:, 2]].astype(np.float32)
    a = (d0 + d1 + d2) / np.float32(3.0)
    maxdev = np.sqrt(
        np.maximum(
            ((d0 - a) ** 2).sum(-1),
            np.maximum(((d1 - a) ** 2).sum(-1), ((d2 - a) ** 2).sum(-1)),
        )
    )
    return np.float32(pad) * a, np.float32(pad) * maxdev


def _seg_origin_dist(p, q):
    """Distance from the origin to segment(p, q), vectorized f32."""
    d = q - p
    dd = (d * d).sum(-1)
    t = np.clip(
        -(p * d).sum(-1) / np.maximum(dd, np.float32(1e-30)), 0.0, 1.0
    )
    x = p + t[:, None] * d
    return np.linalg.norm(x, axis=-1).astype(np.float32)


def _tri_minr(verts_norm, tris_h, pad: float, pad_dirs) -> np.ndarray:
    """Conservative per-triangle lower bound on any hit's distance from the
    origin (f64): bounding ball |c| - r, grown by ``pad`` (a ball) or, with
    ``pad_dirs``, by the capsule of :func:`_capsule_params`; a 1e-3 relative
    and 1e-6 absolute margin covers the f32 kernel's rounding. The chunk-skip
    bounds of both accels are built from it."""
    verts_h = np.asarray(verts_norm, np.float32)
    tris_h = np.asarray(tris_h)
    tv = np.asarray(verts_norm, np.float64)[tris_h]
    cc = tv.mean(axis=1)
    rr = np.sqrt(((tv - cc[:, None, :]) ** 2).sum(-1)).max(axis=1)
    if pad and pad_dirs is not None:
        offs, r_extra = _capsule_params(
            verts_h, tris_h, pad, np.asarray(pad_dirs, np.float32)
        )
        cdist = _seg_origin_dist(
            (cc - offs).astype(np.float32), (cc + offs).astype(np.float32),
        ).astype(np.float64)
        rr = rr + r_extra.astype(np.float64)
        cdist = cdist * (1.0 - 3e-7)  # the f32 distance can round above exact
    else:
        if pad:  # deformed hits stay inside the padded ball
            rr = rr + float(pad)
        cdist = np.linalg.norm(cc, axis=-1)
    tb = np.maximum(cdist - rr, 0.0)
    return np.maximum(tb * (1.0 - 1e-3) - 1e-6, 0.0)


def _cone_keys_np(verts_h: np.ndarray, tris_h: np.ndarray, g: int,
                  span: int, pad: float = 0.0, pad_dirs=None):
    """Per-triangle direction cones -> cubemap cell rectangles + overflow.

    Returns (rects [6, 5, T] int32 rows (iu0, iu1, iv0, iv1, fits),
    over [T] bool). A triangle's bounding ball (centroid c, radius r) gives
    the cone (axis c/|c|, half-angle asin(r/|c|)); per cube face, the cone's
    azimuthal extents give a conservative u/v interval. Balls near the
    origin, and rectangles wider than ``span`` cells, overflow.

    ``pad`` > 0 pads for deformation: any displacement of at most ``pad``
    (the ball grows by ``pad``), or, with ``pad_dirs`` [V,3], any
    displacement v' = v + s * pad_dirs[v] with |s| <= pad. Then every
    deformed point lies in the hull of the six corners v_i +- pad*d_i: on a
    face where all six have a positive dominant coordinate the rectangle is
    the corners' direction extrema (the mediant inequality), elsewhere the
    capsule bound of :func:`_capsule_params`; the near-origin, relevance and
    empty flags come from the capsule. Degenerate triangles stay in the
    overflow when padded (a deformation can give them area)."""
    verts_h = np.asarray(verts_h, np.float32)
    tris_h = np.asarray(tris_h)
    v0 = verts_h[tris_h[:, 0]]
    v1 = verts_h[tris_h[:, 1]]
    v2 = verts_h[tris_h[:, 2]]

    c = (v0 + v1 + v2) / np.float32(3.0)
    pad = np.float32(pad)
    r = np.sqrt(
        np.maximum(
            ((v0 - c) ** 2).sum(-1),
            np.maximum(((v1 - c) ** 2).sum(-1), ((v2 - c) ** 2).sum(-1)),
        )
    )
    corners = None
    if pad_dirs is not None and pad > 0.0:
        offs, r_extra = _capsule_params(verts_h, tris_h, pad, pad_dirs)
        centers = (c - offs, c + offs)
        r = r + r_extra
        d_origin = _seg_origin_dist(c - offs, c + offs)
        # the six deformed-hull corners v_i +- pad*d_i, [6, T, 3]
        dirs = np.asarray(pad_dirs, np.float32)
        d0 = np.float32(pad) * dirs[tris_h[:, 0]]
        d1 = np.float32(pad) * dirs[tris_h[:, 1]]
        d2 = np.float32(pad) * dirs[tris_h[:, 2]]
        corners = np.stack([
            v0 - d0, v0 + d0, v1 - d1, v1 + d1, v2 - d2, v2 + d2,
        ])
    else:
        centers = (c,)
        r = r + pad
        d_origin = np.linalg.norm(c, axis=-1).astype(np.float32)

    near_origin = d_origin <= np.float32(1.5) * r + np.float32(1e-7)

    guard = np.float32(1e-4)
    max_face_angle = np.float32(np.arccos(1.0 / np.sqrt(3.0)) + 1e-3)

    def ball_face_terms(cc):
        """Per endpoint ball: (chat, sin_a, alpha) of the interval math."""
        cn = np.linalg.norm(cc, axis=-1).astype(np.float32)
        safe_cn = np.maximum(cn, np.float32(1e-20))
        chat = cc / safe_cn[:, None]
        sin_a = np.minimum(
            r / safe_cn * np.float32(1.0 + 1e-5) + np.float32(1e-6),
            np.float32(1.0),
        )
        alpha = np.arcsin(np.clip(sin_a, 0.0, 1.0)).astype(np.float32)
        return chat, sin_a, alpha

    terms = [ball_face_terms(cc) for cc in centers]

    def face_interval(sin_a, ca, cb):
        rho = np.sqrt(ca * ca + cb * cb)
        full = (sin_a >= rho - np.float32(1e-6)) | (
            sin_a >= np.float32(1.0 - 1e-6)
        )
        dphi = np.arcsin(
            np.clip(sin_a / np.maximum(rho, np.float32(1e-20)), 0.0, 1.0)
        )
        full = full | (dphi >= np.float32(np.pi / 2) - guard)
        az = np.arctan2(cb, ca).astype(np.float32)
        lo = az - dphi - guard
        hi = az + dphi + guard
        empty = (~full) & (
            (lo > np.float32(np.pi / 2)) | (hi < np.float32(-np.pi / 2))
        )
        lim = np.float32(np.pi / 2 - 1e-4)
        u_lo = np.where(full, np.float32(-1.0), np.tan(np.clip(lo, -lim, lim)))
        u_hi = np.where(full, np.float32(1.0), np.tan(np.clip(hi, -lim, lim)))
        return (
            np.clip(u_lo - np.float32(1e-5), -1.0, 1.0).astype(np.float32),
            np.clip(u_hi + np.float32(1e-5), -1.0, 1.0).astype(np.float32),
            empty,
        )

    rects = []
    spans = []
    half_g = np.float32(0.5 * g)
    for f in range(6):
        a = f >> 1
        s = np.float32(1.0 if f % 2 == 0 else -1.0)
        b, cax = int(_OTHERS[a, 0]), int(_OTHERS[a, 1])
        # union over the capsule's endpoints (one for the ball)
        u_lo = v_lo = None
        relevant = empty_u = empty_v = None
        for chat, sin_a, alpha in terms:
            ca = s * chat[:, a]
            rel = (
                np.arccos(np.clip(ca, -1.0, 1.0)).astype(np.float32)
                - alpha <= max_face_angle
            )
            ul, uh, eu = face_interval(sin_a, ca, chat[:, b])
            vl, vh, ev = face_interval(sin_a, ca, chat[:, cax])
            if u_lo is None:
                u_lo, u_hi, v_lo, v_hi = ul, uh, vl, vh
                relevant, empty_u, empty_v = rel, eu, ev
            else:
                u_lo = np.minimum(u_lo, ul)
                u_hi = np.maximum(u_hi, uh)
                v_lo = np.minimum(v_lo, vl)
                v_hi = np.maximum(v_hi, vh)
                relevant = relevant | rel
                empty_u = empty_u & eu
                empty_v = empty_v & ev
        if corners is not None:
            # where every corner's dominant coordinate is safely positive,
            # the corner extrema bound all hull directions; mixed-sign faces
            # keep the capsule interval
            pa = s * corners[..., a]
            pb = corners[..., b]
            pc = corners[..., cax]
            all_pos = (pa > np.float32(1e-12)).all(axis=0)
            safe_pa = np.maximum(pa, np.float32(1e-30))
            uc = pb / safe_pa
            vc_ = pc / safe_pa
            hg = np.float32(2e-4)  # fp guard in u (cells are >= 2/g wide)

            def hull(lo_or_hi, vals, cur):
                ext = vals.min(axis=0) - hg if lo_or_hi else vals.max(axis=0) + hg
                return np.where(all_pos,
                                np.clip(ext, -1.0, 1.0).astype(np.float32), cur)

            u_lo, u_hi = hull(True, uc, u_lo), hull(False, uc, u_hi)
            v_lo, v_hi = hull(True, vc_, v_lo), hull(False, vc_, v_hi)
        face_ok = relevant & (~empty_u) & (~empty_v) & (~near_origin)
        iu0 = np.clip(((u_lo + 1.0) * half_g).astype(np.int32), 0, g - 1)
        iu1 = np.clip(((u_hi + 1.0) * half_g).astype(np.int32), 0, g - 1)
        iv0 = np.clip(((v_lo + 1.0) * half_g).astype(np.int32), 0, g - 1)
        iv1 = np.clip(((v_hi + 1.0) * half_g).astype(np.int32), 0, g - 1)
        su = iu1 - iu0 + 1
        sv = iv1 - iv0 + 1
        fits = face_ok & (su <= span) & (sv <= span)
        spans.append((face_ok, fits))
        rects.append(
            np.stack([iu0, iu1, iv0, iv1, fits.astype(np.int32)], axis=0)
        )
    over = near_origin
    for face_ok, fits in spans:
        over = over | (face_ok & ~fits)
    # degenerate triangles never hit: keep them out of the overflow stream,
    # unless padded (a deformation can give them area)
    valid_tri = (
        np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1) > 0.0
    ) | (pad > 0.0)
    over = over & valid_tri
    return np.stack(rects, axis=0), over


def _cone_bins_host(rects_h: np.ndarray, over_h: np.ndarray, g: int,
                    span: int):
    """Rectangle expansion + stable sort + CSR. Within every cell the
    candidates ascend by (du, dv, tri). Returns (sorted_tris, starts,
    counts, ov_ids)."""
    n_cells = 6 * g * g
    t_count = rects_h.shape[-1]
    iu0 = rects_h[:, 0].reshape(-1)  # [6*T], face-major
    iv0 = rects_h[:, 2].reshape(-1)
    su = rects_h[:, 1].reshape(-1) - iu0 + 1
    sv = rects_h[:, 3].reshape(-1) - iv0 + 1
    fits = rects_h[:, 4].reshape(-1) != 0
    face_base = (
        np.repeat(np.arange(6, dtype=np.int64), t_count) * (g * g)
    )
    kparts, tparts = [], []
    for du in range(span):
        okr = fits & (du < su)
        rows = np.flatnonzero(okr)
        if rows.size == 0:
            continue
        cell_u = face_base[rows] + (iu0[rows] + du).astype(np.int64) * g
        cell_v0 = iv0[rows].astype(np.int64)
        svr = sv[rows]
        tri = (rows % t_count).astype(np.int32)
        for dv in range(span):
            sel = dv < svr
            if not sel.all():
                cell_u, cell_v0, svr, tri = (
                    cell_u[sel], cell_v0[sel], svr[sel], tri[sel]
                )
            if tri.size == 0:
                break
            kparts.append(cell_u + cell_v0 + dv)
            tparts.append(tri)
    if kparts:
        kv = np.concatenate(kparts)
        tv = np.concatenate(tparts)
    else:
        kv = np.zeros((0,), np.int64)
        tv = np.zeros((0,), np.int32)
    order = np.argsort(kv, kind="stable")
    sorted_keys = kv[order]
    sorted_tris = tv[order]
    starts = np.searchsorted(sorted_keys, np.arange(n_cells + 1)).astype(
        np.int64
    )
    counts = (starts[1:] - starts[:-1]).astype(np.int32)
    ov_ids = np.flatnonzero(over_h).astype(np.int32)
    return sorted_tris, starts, counts, ov_ids


def _csr_gather(data, offs, sel):
    """``np.concatenate([data[offs[i]:offs[i+1]] for i in sel])``,
    vectorized."""
    lens = offs[sel + 1] - offs[sel]
    total = int(lens.sum())
    if total == 0:
        return data[:0]
    heads = np.repeat(offs[sel], lens)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(lens) - lens, lens
    )
    return data[heads + within]


def _fold_levels_csr(level_runs, g_fine: int):
    """Fold every ladder level's cell bins into the FINEST level's cells as
    one CSR (offs [C+1] i64, data i64 global ids): each fine cell's list is
    one run per level, in ladder order (fine -> coarse)."""
    nc_fine = 6 * g_fine * g_fine
    fine = np.arange(nc_fine, dtype=np.int64)
    f, rem = np.divmod(fine, g_fine * g_fine)
    iu, iv = np.divmod(rem, g_fine)
    per_level = []
    lens = np.zeros((nc_fine,), np.int64)
    for glob_ids, starts, counts, g in level_runs:
        factor = g_fine // g
        parent = f * (g * g) + (iu // factor) * g + (iv // factor)
        m = counts[parent]
        per_level.append((glob_ids, starts[parent].astype(np.int64), m))
        lens += m
    offs = np.zeros((nc_fine + 1,), np.int64)
    np.cumsum(lens, out=offs[1:])
    data = np.empty((int(offs[-1]),), np.int64)
    prefix = offs[:-1].copy()
    for glob_ids, pstart, m in per_level:
        total = int(m.sum())
        if total == 0:
            continue
        within = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(m) - m, m
        )
        data[np.repeat(prefix, m) + within] = (
            glob_ids[np.repeat(pstart, m) + within]
        )
        prefix += m
    return offs, data


def _make_packs(cell_csr, ray_table, rc, tri_bounds):
    """The strip-packing walk: the native tier's
    (utils/native.accel_pack_native) when it builds, else
    :func:`_make_packs_py`; the two are equal bit for bit."""
    from dxrvoxelizer_tpu_torch.utils import native

    out = native.accel_pack_native(cell_csr[0], cell_csr[1], ray_table, rc,
                                   tri_bounds)
    return out if out is not None else _make_packs_py(cell_csr, ray_table, rc,
                                                      tri_bounds)


def _make_packs_py(cell_csr, ray_table, rc, tri_bounds):
    """Greedy strip packing -> CSR quadruple (ray_data i32, ray_offs i64,
    id_data i64, id_offs i64): pack p owns rays ray_data[ray_offs[p]:
    ray_offs[p+1]] (<= 128) and the bound-sorted unique candidate ids
    id_data[id_offs[p]:id_offs[p+1]]. Small cells share a strip (the
    union of their lists is a safe candidate set: the binning is a
    conservative prefilter); cells larger than a strip span several strips,
    cut in origin-radius order."""
    cell_offs, cell_data = cell_csr
    packs: list = []  # (rays [<=128] int32, union candidate ids)
    cur_rays: list = []
    cur_ids: list = []
    cur_n = 0

    # packed dedupe+order key per id: the bound's high 40 IEEE bits with
    # the id in the low 24 (ids < 2^24; bounds are non-negative doubles, so
    # bit patterns order like values)
    max_id = int(cell_data.max()) if cell_data.size else 0
    if tri_bounds is not None:
        hi = np.asarray(tri_bounds[: max_id + 1], np.float64).view(np.uint64)
        key_tab = (hi & np.uint64(~np.uint64(0xFFFFFF))) | np.arange(
            max_id + 1, dtype=np.uint64
        )
    else:
        key_tab = np.arange(max_id + 1, dtype=np.uint64)

    def uniq_ids(ids):
        keys = np.unique(key_tab[ids])
        return (keys & np.uint64(0xFFFFFF)).astype(np.int64)

    def close():
        nonlocal cur_rays, cur_ids, cur_n
        if cur_rays:
            ids = uniq_ids(np.concatenate(cur_ids))
            packs.append((np.concatenate(cur_rays), ids))
        cur_rays, cur_ids, cur_n = [], [], 0

    for cell in range(cell_offs.shape[0] - 1):
        ids_c = cell_data[cell_offs[cell] : cell_offs[cell + 1]]
        nray = int(rc[cell])
        if ids_c.shape[0] == 0 or nray == 0:
            continue  # no candidates / no voxel direction in this cell
        if nray > 128:
            close()
            ids_sorted = uniq_ids(ids_c)
            full = ray_table[cell, :nray]
            for s in range(0, nray, 128):
                seg = full[s : s + 128]
                if seg.shape[0] == 128:
                    packs.append((seg, ids_sorted))
                else:  # tail strip joins the packing pool
                    cur_rays.append(seg)
                    cur_ids.append(ids_c)
                    cur_n = seg.shape[0]
            continue
        if cur_n + nray > 128:
            close()
        cur_rays.append(ray_table[cell, :nray])
        cur_ids.append(ids_c)
        cur_n += nray
    close()

    ray_offs = np.zeros((len(packs) + 1,), np.int64)
    id_offs = np.zeros((len(packs) + 1,), np.int64)
    if packs:
        ray_offs[1:] = np.cumsum([p[0].shape[0] for p in packs])
        id_offs[1:] = np.cumsum([p[1].shape[0] for p in packs])
        ray_data = np.concatenate([p[0] for p in packs]).astype(np.int32)
        id_data = np.concatenate([p[1] for p in packs]).astype(np.int64)
    else:
        ray_data = np.zeros((0,), np.int32)
        id_data = np.zeros((0,), np.int64)
    return ray_data, ray_offs, id_data, id_offs


def _pack_classes2(cell_ids, ray_table, rc, s0_p, tri_bounds):
    """Partition the rays into capacity classes of packed strips -> the
    compact per-class product [(rt128 [VC,128] i32 ray ids / -1,
    tab [VC,K] i32 candidate ids / -1, bounds [VC,K/256] f32 or None)],
    and the strip count.

    Candidates are sorted by ``tri_bounds`` (a strict lower bound on any hit
    distance of the triangle from the origin), so classes wider than one
    256-candidate chunk carry per-(strip, chunk) lower bounds on t that let
    the query skip a chunk once every lane's winner beats it (near-to-far
    traversal)."""

    def chunk_bounds(rt128, tab, k):
        if tri_bounds is None or k <= K_BLOCK:
            return None
        # chunk lower bound on t = (min candidate R in chunk) - (max ray
        # origin radius in strip); candidates ascend by the 40-bit-truncated
        # bound key, and tri_bounds carries a 1e-3 relative / 1e-6 absolute
        # slack that keeps the chunk head's bound conservative
        tab_sub = tab[:, ::K_BLOCK]  # [rows, k//256] chunk heads
        chunk_lo = np.where(
            tab_sub >= 0, tri_bounds[np.maximum(tab_sub, 0)], np.inf
        )
        idx = np.where(rt128 >= 0, rt128, 0)
        s0m = np.where(rt128 >= 0, s0_p[idx], 0.0).max(axis=1)
        return np.maximum(chunk_lo - s0m[:, None], 0.0).astype(np.float32)

    ray_data, ray_offs, id_data, id_offs = _make_packs(
        cell_ids, ray_table, rc, tri_bounds
    )
    compact = []
    total_vc = 0
    sizes = id_offs[1:] - id_offs[:-1]
    max_k = int(sizes.max()) if sizes.size else 0
    caps = [k for k in CLASS_CAPS2 if k < max_k]
    caps.append(max(_pow2cap(max_k), 8))
    lo = 0
    for k in caps:
        sel = np.nonzero((sizes > lo) & (sizes <= k))[0]
        lo = k
        if sel.size == 0:
            continue
        sel = sel[np.argsort(-sizes[sel], kind="stable")]
        vc = sel.size
        ray_lens = ray_offs[sel + 1] - ray_offs[sel]
        rt128 = np.full((vc, 128), -1, np.int32)
        rt128[np.arange(128)[None, :] < ray_lens[:, None]] = (
            _csr_gather(ray_data, ray_offs, sel)
        )
        tab = np.full((vc, k), -1, np.int32)
        tab[np.arange(k)[None, :] < sizes[sel][:, None]] = (
            _csr_gather(id_data, id_offs, sel)
        )
        compact.append((rt128, tab, chunk_bounds(rt128, tab, k)))
        total_vc += vc
    return compact, total_vc


@dataclass
class RaystabCompact2:
    """What the binning + packing decide, none of the device tables.

    ``classes``: per capacity class, (rt128 [VC,128] i32 ray ids / -1,
    tab [VC,K] i32 candidate triangle ids / -1, bounds [VC,K/256] f32 chunk
    lower bounds on t, or None). ``ov_ids``: near-origin triangle ids [O]
    i32, tested against every ray, or None."""

    n: int
    classes: tuple
    ov_ids: np.ndarray | None
    stats: Raystab2Stats


def build_raystab_compact2(verts_norm, tris, n: int = 64,
                           gs: tuple | None = None, pad: float = 0.0,
                           pad_dirs=None) -> RaystabCompact2:
    """Binning + packing half of the accel build (host): bin each triangle
    at the finest cubemap level whose ``SPAN``-cell rectangle covers its
    direction cone; only cones containing the origin fall through to the
    near-origin list. ``gs``: the cubemap ladder, fine -> coarse
    (default by grid size, :func:`default_gs`).

    ``pad`` > 0 builds a deformation-padded compact (``_cone_keys_np``,
    ``_tri_minr``): its candidate sets and chunk bounds stay conservative
    for every frame within the pad, so one compact serves a deforming mesh
    and only the candidate rows are regathered per frame
    (ops/raystab_refit.py). ``pad_dirs`` [V,3] declares the deformation
    directional (v' = v + s * pad_dirs[v], |s| <= pad)."""
    gs = default_gs(n) if gs is None else gs
    tris_h = _host(tris)
    verts_h = _host_f32(verts_norm)
    t_count = int(tris_h.shape[0])
    assert t_count < 2**24, (
        f"{t_count} triangles exceed the 2^24 id range of the f32 id "
        "channel (reduce -subdiv or decimate the mesh)"
    )
    dirs_h = None if pad_dirs is None else _host_f32(pad_dirs)
    sub_ids = np.arange(t_count, dtype=np.int32)
    stat_levels = []

    # s0 (per-voxel origin radius) feeds the conservative chunk-skip bounds
    _, s0 = _ray_params(n)
    s0_p = np.concatenate([s0.numpy(), np.zeros((1,), np.float32)])

    # bin at each ladder level, then fold every level's cells into the
    # finest level's cell lists (one query stream)
    g_fine = gs[0]
    level_runs = []  # per level: (global ids in bin order, starts, counts, g)
    for g in gs:
        if sub_ids.size == 0:
            break
        rects_h, over_h = _cone_keys_np(verts_h, tris_h[sub_ids], g, SPAN,
                                        pad, dirs_h)
        sorted_tris, starts, counts_h, ov_np = _cone_bins_host(
            rects_h, over_h, g, SPAN
        )
        level_runs.append((
            sub_ids[sorted_tris].astype(np.int64), starts,
            counts_h.astype(np.int64), g,
        ))
        stat_levels.append((g, int((counts_h > 0).sum()), 0,
                            int(counts_h.max()) if counts_h.size else 0, 0))
        sub_ids = sub_ids[ov_np]

    cell_offs, cell_data = _fold_levels_csr(level_runs, g_fine)
    m_counts = cell_offs[1:] - cell_offs[:-1]
    compact_classes, total_vc = [], 0
    if m_counts.size and m_counts.max() > 0:
        tri_bounds = _tri_minr(verts_h, tris_h, pad, dirs_h)
        ray_table, rc = _ray_table_filled(n, g_fine)
        compact_classes, total_vc = _pack_classes2(
            (cell_offs, cell_data), ray_table, rc, s0_p, tri_bounds
        )
    # one row per ladder level; the fine row carries the merged numbers
    if stat_levels:
        stat_levels[0] = (g_fine, int((m_counts > 0).sum()),
                          _pow2cap(int(m_counts.max())),
                          int(m_counts.max()), total_vc)
    return RaystabCompact2(
        n=n,
        classes=tuple(compact_classes),
        ov_ids=sub_ids.copy() if sub_ids.size > 0 else None,
        stats=Raystab2Stats(
            levels=tuple(stat_levels), near_origin=int(sub_ids.size)
        ),
    )


def _radial_coef_matrix(verts_norm, tris):
    """Radial coefficient rows [T+1, 12]: g0 g1 g2 c id pad; the appended
    padding row is all-zero with id 2^30 (den == 0 -> miss, loses ties)."""
    t_count = int(tris.shape[0])
    assert t_count < 2**24, (
        f"{t_count} triangles exceed the 2^24 id range of the f32 id channel"
    )
    g0, g1, g2, c = intersect.radial_setup(verts_norm, tris)
    idf = torch.arange(t_count, device=c.device, dtype=torch.float32)[:, None]
    cf = torch.cat([g0, g1, g2, c[:, None], idf, torch.zeros_like(idf)], dim=-1)
    # built on the device (no host copy: the refit's rows must not sync)
    col = torch.arange(12, device=c.device)
    pad_row = torch.where(col == 10, float(intersect.BIG_ID), 0.0)[None]
    return torch.cat([cf.to(torch.float32), pad_row.to(torch.float32)])


def _normal_rows_matrix(normals, tris):
    """Per-triangle normal rows [T+1, 12]: n0 n1 n2 pad(3), last row zero —
    raw vertex-normal gathers, bit-identical to the oracle's
    ``normals[tris[:, k]]``."""
    nv = normals.to(torch.float32)
    rows = torch.cat([nv[tris[:, 0]], nv[tris[:, 1]], nv[tris[:, 2]],
                      torch.zeros((tris.shape[0], 3), dtype=torch.float32,
                                  device=nv.device)], dim=-1)
    return torch.cat([rows, torch.zeros((1, 12), dtype=torch.float32,
                                        device=nv.device)])


def _fused_coef_matrix(verts_norm, tris, normals):
    """[T+1, 24] = radial coefficient rows | normal rows: the candidate row
    the kernel streams (one gather per candidate)."""
    return torch.cat([_radial_coef_matrix(verts_norm, tris),
                      _normal_rows_matrix(normals, tris)], dim=-1)


REFIT_ROWS = _cuda.Kernel(
    name="refit_rows",
    symbol="refit_rows_kernel",
    source="dxrvoxelizer_tpu_torch/csrc/refit_rows.cu",
    replaces="dxrvoxelizer_tpu/ops/raystab_fast.py:1297",
)


def fused_coef_matrix(verts_norm, tris, normals, use_kernel: bool = True):
    """The per-triangle rows [T+1, 24] of :func:`_fused_coef_matrix` (its
    plain version, taken on a CPU tensor or under ``use_kernel=False``): on
    a CUDA tensor one launch of X.9 (``csrc/refit_rows.cu``), bit for bit
    the plain chain. ``verts_norm`` and ``normals`` [V,3] float32
    (another dtype raises: nothing is cast), ``tris`` [T,3] int64 or int32
    whose data starts 16-byte aligned (else it raises; a whole allocation
    does), all contiguous."""
    dev = verts_norm.device
    if not use_kernel or dev.type == "cpu":
        return _fused_coef_matrix(verts_norm, tris, normals)
    t_count = int(tris.shape[0])
    if t_count >= 2**24:
        raise ValueError(f"{t_count} triangles exceed the 2^24 id range of "
                         "the f32 id channel")
    if tris.dtype not in (torch.int64, torch.int32):
        raise ValueError(f"tris: expected int64 or int32, got {tris.dtype}")
    _cuda.require(verts_norm, "verts_norm", torch.float32,
                  (verts_norm.shape[0], 3))
    _cuda.require(normals, "normals", torch.float32, (normals.shape[0], 3))
    _cuda.require(tris, "tris", tris.dtype, (t_count, 3))
    if tris.data_ptr() % 16 != 0:
        raise ValueError("tris: expected a 16-byte aligned tensor (X.9 stages "
                         "the index runs in 16-byte units)")
    if normals.device != dev or tris.device != dev:
        raise ValueError(f"normals and tris: expected {dev}, got "
                         f"{normals.device} and {tris.device}")
    out = torch.empty((t_count + 1, raystab_cuda.NROW), dtype=torch.float32,
                      device=dev)
    code = _cuda.load().dxv_refit_rows(
        verts_norm.data_ptr(), tris.data_ptr(), normals.data_ptr(),
        out.data_ptr(), t_count, int(verts_norm.shape[0]),
        int(normals.shape[0]), int(tris.dtype == torch.int64),
        _cuda.stream_ptr(dev))
    _cuda.check(code, REFIT_ROWS.name)
    REFIT_ROWS.launches += 1
    return out


ROWS_BLOCK = 128  # X.9's rows a block (csrc/refit_rows.cu kThreads)


def fused_rows_mirror(verts: np.ndarray, tris: np.ndarray,
                      normals: np.ndarray) -> np.ndarray:
    """X.9 block by block in numpy -> [T+1, 24] (NaN where no store landed).
    Each block of ROWS_BLOCK rows copies its triangles' index run into
    shared memory as 16-byte units and a 4-byte tail (``tris`` must start
    16-byte aligned, as the wrapper requires: else ValueError), each thread
    checks its three indices (IndexError where the kernel traps) and
    computes its row, each cross component ``ay * bz - az * by`` and ``c = (g0x v0x + g0y v0y) + g0z v0z`` one float32 rounding
    at a time in the kernel's order, into the block's rows (the padding row
    in the block that holds row T), and the block stores its rows as one
    run of 16-byte units."""
    f = np.float32
    if tris.dtype not in (np.int32, np.int64):
        tris = tris.astype(np.int64)
    tris = np.ascontiguousarray(tris)
    if tris.ctypes.data % 16 != 0:
        raise ValueError("tris: expected a 16-byte aligned array")
    t_count = tris.shape[0]
    words_all = tris.reshape(-1).view(np.uint32)
    verts, normals = verts.astype(f), normals.astype(f)
    out = np.full(((t_count + 1) * 6, 4), np.nan, f)
    for t0 in range(0, t_count + 1, ROWS_BLOCK):
        real = min(ROWS_BLOCK, t_count - t0)
        smem = np.zeros(ROWS_BLOCK * 3 * tris.itemsize // 4, np.uint32)
        if real > 0:  # 1. the index run: 16-byte units, then the tail
            words = real * 3 * tris.itemsize // 4
            run = words_all[t0 * 3 * tris.itemsize // 4:][:words]
            units = words // 4
            smem[:units * 4] = run[:units * 4]
            smem[units * 4:words] = run[units * 4:words]
        rows = np.full((ROWS_BLOCK * 6, 4), np.nan, f)
        r = np.arange(max(real, 0))
        idx = smem.view(tris.dtype).astype(np.int64)
        a, b, c = (idx[3 * r + k] for k in range(3))
        lo = np.minimum(a, np.minimum(b, c))
        hi = np.maximum(a, np.maximum(b, c))
        if ((lo < 0) | (hi >= verts.shape[0]) | (hi >= normals.shape[0])).any():
            raise IndexError("X.9 traps: a triangle index outside [0, V)")
        v0, v1, v2 = verts[a], verts[b], verts[c]
        n0, n1, n2 = normals[a], normals[b], normals[c]

        def cross(p, q):
            return np.stack([p[:, 1] * q[:, 2] - p[:, 2] * q[:, 1],
                             p[:, 2] * q[:, 0] - p[:, 0] * q[:, 2],
                             p[:, 0] * q[:, 1] - p[:, 1] * q[:, 0]], -1)

        g0, g1, g2 = cross(v1, v2), cross(v2, v0), cross(v0, v1)
        cc = (g0[:, 0] * v0[:, 0] + g0[:, 1] * v0[:, 1]) + g0[:, 2] * v0[:, 2]
        zero = np.zeros(r.size, f)
        stores = [  # row[0..5], as the thread's float4 writes
            (g0[:, 0], g0[:, 1], g0[:, 2], g1[:, 0]),
            (g1[:, 1], g1[:, 2], g2[:, 0], g2[:, 1]),
            (g2[:, 2], cc, (t0 + r).astype(f), zero),
            (n0[:, 0], n0[:, 1], n0[:, 2], n1[:, 0]),
            (n1[:, 1], n1[:, 2], n2[:, 0], n2[:, 1]),
            (n2[:, 2], zero, zero, zero),
        ]
        for j, st in enumerate(stores):
            rows[r * 6 + j] = np.stack(st, -1)
        if 0 <= t_count - t0 < ROWS_BLOCK:  # the padding row
            pad = (t_count - t0) * 6
            rows[pad:pad + 6] = 0.0
            rows[pad + 2, 2] = f(intersect.BIG_ID)
        units = min(ROWS_BLOCK, t_count + 1 - t0) * 6  # 4. the block's run
        out[t0 * 6:t0 * 6 + units] = rows[:units]
    return out.reshape(t_count + 1, 24)


@dataclass
class RaystabAccel2:
    """The gen-6 accel on the device (the TLAS analog).

    ``main``: every class's strips as one :class:`StripTables` stream, or
    None when no triangle was binned; ``slot_ray`` [S*128] int64: the ray of
    each of its output slots (V for padding slots, a dump row), and
    ``ray_slot`` [V] int32 its inverse, the slot of each ray (-1: no strip
    covers it; ``grid_cuda.ray_slots``, what X.10 reads). ``ov``: the
    near-origin stream (every ray in natural order, strips of 128 against the
    shared near-origin rows), or None. ``device``: where the tables live.
    ``t_count``: the mesh's triangle count (ids at or above it are misses)."""

    n: int
    t_count: int
    device: torch.device
    main: StripTables | None
    slot_ray: torch.Tensor | None
    ov: StripTables | None
    stats: Raystab2Stats
    ray_slot: torch.Tensor | None = None


def _strip_rays(rt128: torch.Tensor, dirs_p: torch.Tensor,
                s0_p: torch.Tensor) -> torch.Tensor:
    """Ray rows [S, 4, 128] (dx dy dz s0) of strips of ray ids (-1 padding:
    an all-zero lane, so den == 0 and it never hits)."""
    v = dirs_p.shape[0] - 1
    ridx = torch.where(rt128 >= 0, rt128, v)
    return torch.cat([dirs_p[ridx].transpose(1, 2), s0_p[ridx][:, None, :]],
                     dim=1).contiguous()


def stream_ids2(compact: RaystabCompact2, device) -> dict:
    """The triangle id of every candidate row of each strip stream ("main",
    "ov") an accel assembled from ``compact`` has, as int64 tensors on
    ``device``: its rows are ``fused[ids]``."""
    out = {}
    if compact.classes:
        out["main"] = np.concatenate([c[1][c[1] >= 0] for c in compact.classes])
    if compact.ov_ids is not None:
        out["ov"] = compact.ov_ids
    return {k: torch.from_numpy(v.astype(np.int64)).to(device)
            for k, v in out.items()}


def stream_rows(fused: torch.Tensor, ids: torch.Tensor, by_id: bool) -> dict:
    """A strip stream's candidate rows ``fused[ids]``: gathered (``rows``),
    or ``by_id`` as the table and its int32 ids (``rows``, ``row_ids``),
    which the fold reads through the ids and nothing gathers."""
    if by_id:
        return {"rows": fused, "row_ids": ids.to(torch.int32)}
    return {"rows": torch.index_select(fused, 0, ids)}


def assemble_raystab_accel2(compact: RaystabCompact2, verts_norm, tris,
                            normals, by_id: bool = False) -> RaystabAccel2:
    """Device half of the accel build: expand a compact product into the
    strip streams by torch gathers on the geometry's device.

    ``verts_norm``/``tris``/``normals`` must be the geometry the compact was
    built from; the coefficient and normal rows are computed here, so they
    match the same-device oracle bit for bit. ``by_id``: the streams hold
    the per-triangle table and row ids instead of gathered rows
    (:func:`stream_rows`; the refitter's form)."""
    dev = verts_norm.device
    n = compact.n
    v = n * n * n
    fused = fused_coef_matrix(verts_norm, tris, normals)
    dirs, s0 = _ray_params(n, dev)
    dirs_p = torch.cat([dirs, torch.zeros((1, 3), dtype=dirs.dtype, device=dev)])
    s0_p = torch.cat([s0, torch.zeros((1,), dtype=s0.dtype, device=dev)])

    ids = stream_ids2(compact, dev)
    main = slot_ray = ray_slot = None
    if compact.classes:
        rt = np.concatenate([c[0] for c in compact.classes])
        counts = np.concatenate([(c[1] >= 0).sum(axis=1) for c in compact.classes])
        offs = np.zeros_like(counts)
        offs[1:] = np.cumsum(counts)[:-1]
        n_bnd = max((c[2].shape[1] for c in compact.classes if c[2] is not None),
                    default=0)
        bounds = None
        if n_bnd:
            # -inf: no bound, the chunk is always tested
            bnd = np.full((rt.shape[0], n_bnd), -np.inf, np.float32)
            row = 0
            for rt128, _tab, b in compact.classes:
                if b is not None:
                    bnd[row:row + rt128.shape[0], :b.shape[1]] = b
                row += rt128.shape[0]
            bounds = torch.from_numpy(bnd).to(dev)
        rt_d = torch.from_numpy(rt.astype(np.int64)).to(dev)
        main = StripTables(
            rays=_strip_rays(rt_d, dirs_p, s0_p),
            cand_off=torch.from_numpy(offs.astype(np.int32)).to(dev),
            cand_cnt=torch.from_numpy(counts.astype(np.int32)).to(dev),
            bounds=bounds,
            **stream_rows(fused, ids["main"], by_id),
        )
        slot_ray = torch.where(rt_d >= 0, rt_d, v).reshape(-1)
        ray_slot = grid_cuda.ray_slots(slot_ray, v)

    ov = None
    if compact.ov_ids is not None:
        strips = -(-v // 128)
        rt_ov = torch.full((strips * 128,), -1, dtype=torch.int64, device=dev)
        rt_ov[:v] = torch.arange(v, device=dev)
        o = int(compact.ov_ids.shape[0])
        ov = StripTables(
            rays=_strip_rays(rt_ov.reshape(strips, 128), dirs_p, s0_p),
            cand_off=torch.zeros((strips,), dtype=torch.int32, device=dev),
            cand_cnt=torch.full((strips,), o, dtype=torch.int32, device=dev),
            **stream_rows(fused, ids["ov"], by_id),
        )
    return RaystabAccel2(n=n, t_count=int(tris.shape[0]), device=dev,
                         main=main, slot_ray=slot_ray, ov=ov,
                         stats=compact.stats, ray_slot=ray_slot)


def build_raystab_accel2(verts_norm, tris, normals, n: int = 64,
                         gs: tuple | None = None) -> RaystabAccel2:
    """Build the gen-6 accel: host binning/packing, then device assembly.
    Like the reference's AS, it is built once per geometry
    (Voxelizer.cpp:264-326); ``normals`` are baked into the candidate rows."""
    compact = build_raystab_compact2(verts_norm, tris, n, gs)
    return assemble_raystab_accel2(compact, verts_norm, tris, normals)


def strip_streams2(accel: RaystabAccel2) -> dict:
    """The accel's strip streams by name ("main", "ov"), those it has."""
    return {k: tb for k, tb in (("main", accel.main), ("ov", accel.ov))
            if tb is not None}


def _merge_streams2(accel: RaystabAccel2, outs: dict) -> torch.Tensor:
    """The streams' kernel outputs (``outs[name] = (t, id, ns)``) -> per-ray
    finished (nx, ny, nz, a) channels [V, 4].

    The main stream's slots go to ray order through ``slot_ray`` (a scatter:
    the strips partition the rays; padding slots land in the dump row V).
    Rays no strip covers keep zeros. The near-origin stream is already in
    ray order and merges by the same (t, lowest id) rule."""
    v = accel.n ** 3
    dev = accel.device
    ns = torch.zeros((v + 1, 4), dtype=torch.float32, device=dev)
    if "main" in outs:
        t_s, i_s, ns_s = outs["main"]
        ns.index_copy_(0, accel.slot_ray, ns_s.reshape(-1, 4))
    if "ov" not in outs:
        return ns[:v]
    t = torch.full((v + 1,), float("inf"), dtype=torch.float32, device=dev)
    i = torch.full((v + 1,), intersect.BIG_ID, dtype=torch.int32, device=dev)
    if "main" in outs:
        t.index_copy_(0, accel.slot_ray, t_s.reshape(-1))
        i.index_copy_(0, accel.slot_ray, i_s.reshape(-1))
    t_o, i_o, ns_o = outs["ov"]
    t_o, i_o, ns_o = t_o.reshape(-1)[:v], i_o.reshape(-1)[:v], ns_o.reshape(-1, 4)[:v]
    closer = (t_o < t[:v]) | ((t_o == t[:v]) & (i_o < i[:v]))
    return torch.where(closer[:, None], ns_o, ns[:v])


def _stream_outs2(accel: RaystabAccel2, threshold: float, rule: str,
                  use_kernels: bool = True) -> dict:
    """Each strip stream's fold + extraction -> ``{name: (t, id, ns)}``."""
    fold = (raystab_cuda.fold_extract if use_kernels
            else raystab_cuda.fold_extract_plain)
    return {k: fold(tb, accel.t_count, threshold, rule)
            for k, tb in strip_streams2(accel).items()}


def raystab_query2(accel: RaystabAccel2, threshold: float = INSIDE_THRESHOLD,
                   rule: str = "backface", use_kernels: bool = True):
    """Per-frame trace -> (occupancy [n,n,n] bool, rgba [n,n,n,4] f32): the
    streams' fold + extraction, then X.10 merges them with the rounding
    off (the kernels on a CUDA tensor; their plain versions on a CPU one
    or with ``use_kernels=False``, the merge :func:`_merge_streams2`).

    The geometry is baked into the accel's rows. Ground truth is the
    radial oracle (ops/voxelize_ref.voxelize_raystab_radial_ref)."""
    rgba = grid_cuda.merge(accel, _stream_outs2(accel, threshold, rule,
                                                use_kernels),
                           quantize=False, words=False, density=False,
                           use_kernel=use_kernels)[0]
    return rgba[..., 3] != 0.0, rgba


def raystab_grid2(accel: RaystabAccel2, threshold: float = INSIDE_THRESHOLD,
                  rule: str = "backface", quantize: bool = True,
                  gate: torch.Tensor | None = None, use_kernels: bool = True):
    """The query as the frame's grid -> (rgba [n,n,n,4], words [n,n,n/32]
    int32 or None, density [n,n,n] or None): the streams' fold +
    extraction, then X.10 merges them, rounds (``quantize``) and packs the
    merged channels in one launch (``gate``: the ``-normals`` form, gated
    by those words; no words come out). The plain versions on a CPU tensor
    or with ``use_kernels=False`` (``grid_cuda.merge_plain``: the density
    is then None, ``rgba[..., 3]``)."""
    return grid_cuda.merge(accel, _stream_outs2(accel, threshold, rule,
                                                use_kernels),
                           gate=gate, quantize=quantize,
                           use_kernel=use_kernels)


# ---- gen-1: one cubemap level, Moller-Trumbore closest hit ----------------

@dataclass
class RadialBinStats:
    n_cells: int
    capacity: int  # per-cell candidate capacity: a power of two >= max_bin
    max_bin: int
    overflow: int  # triangles tested against every ray


def _cell_table_host(sorted_tris, starts, counts, cap: int) -> np.ndarray:
    """Padded per-cell candidate id table [C, cap] (-1 = empty slot): the JAX
    package's layout of the bins."""
    j = np.arange(cap, dtype=np.int64)[None, :]
    in_run = j < counts[:, None]
    if sorted_tris.size == 0:
        return np.full((counts.shape[0], cap), -1, np.int32)
    run_idx = np.clip(starts[:-1][:, None] + j, 0, sorted_tris.shape[0] - 1)
    return np.where(in_run, sorted_tris[run_idx], -1).astype(np.int32)


def bin_triangles_radial(verts_norm, tris, g: int = 32, span: int = 8):
    """Direction-space binning at one cubemap level (host) -> (cand_ids [P]
    int32, cand_off [C+1] int64, ov_ids [O] int32, stats).

    Cell c's candidates are ``cand_ids[cand_off[c] : cand_off[c+1]]`` in
    (du, dv, tri) order (the JAX package pads them into a [C, capacity]
    table, :func:`_cell_table_host`); ``ov_ids``, ascending, overflow."""
    verts_h, tris_h = _host_f32(verts_norm), _host(tris)
    rects_h, over_h = _cone_keys_np(verts_h, tris_h, g, span)
    sorted_tris, starts, counts, ov_ids = _cone_bins_host(rects_h, over_h, g, span)
    max_bin = int(counts.max()) if counts.size else 0
    stats = RadialBinStats(n_cells=6 * g * g, capacity=_pow2cap(max_bin),
                           max_bin=max_bin, overflow=int(ov_ids.size))
    return sorted_tris, starts, ov_ids, stats


@functools.lru_cache(maxsize=8)
def ray_tables(n: int, g: int):
    """Static voxel->cell grouping as CSR: (ray_ids [V] int32 voxel ids cell
    by cell, ray_off [C+1] int64); cell c's rays are
    ``ray_ids[ray_off[c] : ray_off[c+1]]``."""
    rt, rc = _ray_table_filled(n, g)
    ray_off = np.zeros((rc.shape[0] + 1,), np.int64)
    np.cumsum(rc, out=ray_off[1:])
    return rt[rt >= 0], ray_off


def _mt_rows(verts_norm, tris) -> torch.Tensor:
    """Moller-Trumbore candidate rows [T, 12]: v0 e1 e2, the triangle id as
    f32 (exact below 2^24), pad(2) -- the JAX package's ``_dense_coefs`` row."""
    t_count = int(tris.shape[0])
    assert t_count < 2**24, (
        f"{t_count} triangles exceed the 2^24 id range of the f32 id channel"
    )
    v0, e1, e2 = intersect.triangle_soup(verts_norm, tris)
    idf = torch.arange(t_count, device=v0.device, dtype=torch.float32)[:, None]
    pad = torch.zeros((t_count, 2), dtype=torch.float32, device=v0.device)
    return torch.cat([v0, e1, e2, idf, pad], dim=-1).to(torch.float32).contiguous()


@dataclass
class RaystabAccel:
    """The gen-1 accel on the device (the TLAS analog).

    ``main``: every ray, in slices of at most 128 rays of one direction cell,
    each with its cell's candidate rows; ``ov``: every ray against the
    overflow rows (strips of all rays in voxel order), or None. ``t_count``: the mesh's
    triangle count."""

    n: int
    g: int
    t_count: int
    device: torch.device
    main: MTTables
    ov: MTTables | None
    stats: RadialBinStats


def assemble_raystab_accel(verts_norm, tris, n: int, g: int, groups, ov_ids,
                           stats: RadialBinStats,
                           lanes: int = LANES) -> RaystabAccel:
    """Device half of the gen-1 build: lay the groups out as one slice stream.

    ``groups`` = (ray_ids, ray_off [G+1], cand_ids, cand_off [G+1]) (numpy):
    group i (a direction cell) tests its rays against its candidates. A group
    of more than ``lanes`` rays becomes several slices over the same
    candidate rows; rays no group holds form groups without candidates (they
    miss). Slices are ordered widest candidate list first. ``verts_norm``/
    ``tris`` must be the geometry the groups were built from."""
    dev = verts_norm.device
    v = n * n * n
    ray_ids, ray_off, cand_ids, cand_off = (np.asarray(a) for a in groups)
    r_start, nray = ray_off[:-1], np.diff(ray_off)
    c_start, ncand = cand_off[:-1], np.diff(cand_off)
    covered = np.zeros((v,), bool)
    covered[ray_ids] = True
    rest = np.flatnonzero(~covered).astype(np.int32)
    if rest.size:
        r_start = np.append(r_start, ray_ids.size)
        nray = np.append(nray, rest.size)
        c_start = np.append(c_start, 0)
        ncand = np.append(ncand, 0)
        ray_ids = np.concatenate([ray_ids, rest])
    pos, dirs = voxel_rays(n, dev)
    rows = _mt_rows(verts_norm, tris)
    main = slice_stream(
        pos, dirs, rows[torch.from_numpy(np.asarray(cand_ids, np.int64)).to(dev)],
        ray_ids, r_start, nray, c_start, ncand, lanes)
    ov = None
    if ov_ids.size:  # one group: every ray against every overflow row
        ov = slice_stream(
            pos, dirs, rows[torch.from_numpy(np.asarray(ov_ids, np.int64)).to(dev)],
            np.arange(v), [0], [v], [0], [ov_ids.size], lanes)
    return RaystabAccel(n=n, g=g, t_count=int(tris.shape[0]), device=dev,
                        main=main, ov=ov, stats=stats)


def build_raystab_accel(verts_norm, tris, n: int = 64, g: int = 32,
                        span: int = 8, lanes: int = LANES) -> RaystabAccel:
    """Build the gen-1 accel: host binning at one cubemap level of ``g`` x
    ``g`` cells per face, then the device slice stream (slices of at most
    ``lanes`` rays). Like the reference's AS it is built once per geometry
    (Voxelizer.cpp:264-326); the normals enter at query time."""
    cand_ids, cand_off, ov_ids, stats = bin_triangles_radial(verts_norm, tris,
                                                             g, span)
    ray_ids, ray_off = ray_tables(n, g)
    return assemble_raystab_accel(verts_norm, tris, n, g,
                                  (ray_ids, ray_off, cand_ids, cand_off),
                                  ov_ids, stats, lanes)


def _finalize(verts_norm, normals, tris, pos, dirs, best_t, best_i, n: int,
              threshold: float):
    """Recompute (u, v) at each ray's winning triangle; normals and rgba
    (the JAX package's ``_finalize``, in its expression order)."""
    hit = torch.isfinite(best_t) & (best_i < tris.shape[0])
    idx = torch.where(hit, best_i, 0).to(torch.int64)
    v0, e1, e2 = intersect.triangle_soup(verts_norm, tris)
    _, u, v, _ = intersect.mt_hit(pos, dirs, v0[idx], e1[idx], e2[idx])
    n0, n1, n2 = (normals[tris[idx, k]] for k in range(3))
    inside, nx, ny, nz = intersect.mt_finalize(dirs, n0, n1, n2, u, v, hit,
                                               threshold, "backface")
    rgba = intersect.rgba_channels(inside, nx, ny, nz)
    return inside.reshape(n, n, n), rgba.reshape(n, n, n, 4)


def raystab_query(verts_norm, normals, tris, accel,
                  threshold: float = INSIDE_THRESHOLD, impl: str = "auto",
                  use_kernels: bool = True):
    """Per-frame trace against a built accel -> (occupancy [n,n,n] bool,
    rgba [n,n,n,4] f32).

    Gen-1: the closest-hit kernel on CUDA tensors and its plain version on
    CPU tensors; ``impl="xla"`` or ``use_kernels=False`` asks for the plain
    version ("auto" and "pallas" are the kernel). Then the overflow merge by
    (t, lowest id) and the finalize. ``verts_norm``/``tris`` must be the
    geometry the accel was built from. A :class:`RaystabAccel2` goes to
    :func:`raystab_query2` and a gen-7 accel to
    ``raystab_tiled.raystab_query7`` (their geometry is baked in)."""
    if isinstance(accel, RaystabAccel2):
        return raystab_query2(accel, threshold)
    from dxrvoxelizer_tpu_torch.ops import raystab_tiled

    if isinstance(accel, raystab_tiled.RaystabAccel7):
        return raystab_tiled.raystab_query7(accel, threshold)
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown raystab query impl {impl!r}")
    if int(tris.shape[0]) != accel.t_count:
        raise ValueError(f"the accel was built for {accel.t_count} triangles, "
                         f"got {int(tris.shape[0])}")
    n = accel.n
    if accel.t_count == 0:
        return (torch.zeros((n, n, n), dtype=torch.bool, device=accel.device),
                torch.zeros((n, n, n, 4), dtype=torch.float32, device=accel.device))
    hit_fn = (raystab_mt_cuda.closest_hit if use_kernels and impl != "xla"
              else raystab_mt_cuda.closest_hit_plain)
    best_t, best_i = hit_fn(accel.main)
    if accel.ov is not None:
        t_ov, i_ov = hit_fn(accel.ov)
        closer = (t_ov < best_t) | ((t_ov == best_t) & (i_ov < best_i))
        best_t = torch.where(closer, t_ov, best_t)
        best_i = torch.where(closer, i_ov, best_i)
    return _finalize(verts_norm, normals, tris, accel.main.pos, accel.main.dirs,
                     best_t, best_i, n, threshold)


def voxelize_raystab_fast(verts_norm, normals, tris, n: int = 64,
                          threshold: float = INSIDE_THRESHOLD):
    """Binned reference-rule solid voxelization -> (occupancy, rgba): build
    the accel and query it once, routed as the JAX package routes: gen-1 on
    the CPU at every grid size; on a GPU gen-7 where
    ``raystab_tiled.use_tiled_raystab`` says so (n >= 128), else gen-6.
    Build-once, trace-per-frame callers build an accel and query it
    directly."""
    dev = verts_norm.device
    if tris.shape[0] == 0:
        return (torch.zeros((n, n, n), dtype=torch.bool, device=dev),
                torch.zeros((n, n, n, 4), dtype=torch.float32, device=dev))
    if dev.type == "cpu":
        accel = build_raystab_accel(verts_norm, tris, n=n)
        return raystab_query(verts_norm, normals, tris, accel, threshold)
    from dxrvoxelizer_tpu_torch.ops import raystab_tiled

    if raystab_tiled.use_tiled_raystab(n):
        accel7 = raystab_tiled.build_raystab_accel7(verts_norm, tris, normals, n=n)
        return raystab_tiled.raystab_query7(accel7, threshold)
    accel = build_raystab_accel2(verts_norm, tris, normals, n=n)
    return raystab_query2(accel, threshold)
