"""Gen-7 ray-stab accel: output-major voxel tiles (n >= 128 on a GPU).

Port of ``dxrvoxelizer_tpu/ops/raystab_tiled.py``. Gen-6
(ops/raystab_fast.py) groups rays into strips by direction cell, which
scatters each strip's outputs over the grid. Gen-7 makes a strip a compact
8x4x4 voxel tile (128 consecutive outputs) and gives it the union of the
candidates of every direction cell its rays cross, less the near-prefix
drop: a triangle whose largest possible hit radius (``_tri_maxr``, with
margins) lies below the tile's smallest ray-origin radius is behind every
ray of the tile and is deleted at build. Tiles left without a candidate
never reach the kernel and stay zero.

- Host half (numpy, copied from the JAX package): the cone binning and the
  ladder fold of gen-6, the per-triangle radius bounds ``_tri_maxr`` and
  ``raystab_fast._tri_minr``. The voxel->cell assignment and each tile's
  origin-radius extent depend on the grid alone and are cached per grid.
- The tile union (JAX: ``_tile_union_py`` in numpy, ``accelpack.cpp`` in
  C++) runs as torch operations on the accel's device: the (tile, cell)
  pairs, the CSR expansion, the near drop, the near-origin triangles
  appended to every tile, and the order by (tile, bound, id) from one
  stable sort. The product equals JAX's bit for bit.
- :class:`RaystabCompact7` is that product as one CSR of live tiles; the
  TPU's capacity classes, per-step row padding and 24-bit id packing are
  not carried over. :func:`assemble_raystab_accel7` lays the live tiles out
  as one :class:`~raystab_cuda.StripTables` stream, so the query is one
  launch of the fold + extraction kernel (ops/raystab_cuda.py), and
  :func:`raystab_query7` untiles its outputs: on the card by the
  hand-written kernel X.6 (ops/grid_cuda.py, through the accel's tile ->
  row map ``slots``), which :func:`raystab_grid7` also has round and pack
  them into the frame's grid; elsewhere by one scatter and one permute
  (:func:`untile7`).

Every tile ray's candidate set is a superset of the triangles it can hit
(the cone binning is conservative per ray, the union only adds other lanes'
candidates, and the near drop only removes triangles no lane can hit at
t >= 0), so the query equals the radial oracle (ops/voxelize_ref.py) and
gen-6 bit for bit. :class:`RaystabTiledRefitter` is the deforming-mesh
refit (ops/raystab_refit.py).
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from dxrvoxelizer_tpu_torch.ops import grid_cuda, intersect, raystab_cuda
from dxrvoxelizer_tpu_torch.ops.packing import voxel_centers_norm
from dxrvoxelizer_tpu_torch.ops.raystab_cuda import K_BLOCK, StripTables
from dxrvoxelizer_tpu_torch.ops.raystab_fast import (
    INSIDE_THRESHOLD,
    SPAN,
    _cone_bins_host,
    _cone_keys_np,
    _dir_cells_host,
    _fold_levels_csr,
    _host,
    _host_f32,
    _ray_params,
    _strip_rays,
    _tri_minr,
    default_gs,
    fused_coef_matrix,
    stream_rows,
)
from dxrvoxelizer_tpu_torch.ops.raystab_refit import RaystabRefitter

TILE = grid_cuda.TILE  # x-major voxel tile; its 128 voxels are one strip (n % 8 == 0)
_ID_BITS = 24  # triangle ids < 2^24 (the f32 id channel)


def use_tiled_raystab(n: int) -> bool:
    """Gen routing of the ray-stab accel on a GPU, the JAX package's: gen-7
    at n >= 128, gen-6 below. ``DXRV_RAYSTAB_GEN=6|7`` forces one."""
    forced = os.environ.get("DXRV_RAYSTAB_GEN")
    if forced in ("6", "7"):
        return forced == "7"
    return n >= 128


@dataclass
class Raystab7Stats:
    g_fine: int
    live_tiles: int
    dead_tiles: int
    pairs: int  # candidate slots over the live tiles (no padding)
    near_origin: int  # triangles appended to every tile


@dataclass
class RaystabCompact7:
    """What the binning and the tile union decide, on the device they ran on.

    Live tile ``l`` is tile ``tids[l]`` (ascending; tile ids are x-major over
    the ``TILE``-shaped blocks) with the candidate triangle ids
    ``ids[offs[l] : offs[l+1]]``, ordered by (``_tri_minr`` bound, id).
    ``bounds`` [L, B] f32: for a tile of more than 256 candidates, a lower
    bound on the t of any hit in each of its 256-candidate chunks; -inf
    elsewhere (no bound); None when no tile has more than 256."""

    n: int
    tids: torch.Tensor  # int64 [L]
    offs: torch.Tensor  # int64 [L+1]
    ids: torch.Tensor  # int64 [P]
    bounds: torch.Tensor | None
    stats: Raystab7Stats


@dataclass
class RaystabAccel7:
    """The gen-7 accel on the device: ``main`` the live tiles as one strip
    stream (None when no tile is live), ``tids`` [L] int64 their tile ids,
    ``slots`` [n^3 / 128] int32 each tile's live row (-1: dead; X.6 reads
    it). ``t_count``: the mesh's triangle count."""

    n: int
    t_count: int
    device: torch.device
    main: StripTables | None
    tids: torch.Tensor
    slots: torch.Tensor
    stats: Raystab7Stats


def _tile_ids(n: int) -> np.ndarray:
    """Flat voxel index -> tile id (x-major tiles, raster within)."""
    tx, ty, tz = TILE
    idx = np.arange(n * n * n, dtype=np.int64)
    i, rem = np.divmod(idx, n * n)
    j, k = np.divmod(rem, n)
    return ((i // tx) * (n // ty) + j // ty) * (n // tz) + k // tz


def _tri_maxr(verts_norm, tris_h, pad: float) -> np.ndarray:
    """Conservative per-triangle largest hit radius (f64): the largest
    vertex distance, plus ``pad`` for deforming builds, with a 1e-3 relative
    and 1e-6 absolute margin. A hit point is a convex combination of the
    (padded) vertices, so its radius is at most this; the near drop needs
    the f32 radius strictly below the tile's f32 origin radius, and the
    margin dwarfs both roundings."""
    tv = np.asarray(verts_norm, np.float64)[np.asarray(tris_h)]
    maxr = np.sqrt((tv ** 2).sum(-1)).max(axis=1)
    if pad:
        maxr = maxr + float(pad)
    return maxr * (1.0 + 1e-3) + 1e-6


@functools.lru_cache(maxsize=4)
def _tile_statics(n: int, g: int, device: str):
    """What depends on the grid alone, kept on ``device``: the distinct
    (tile, direction cell) pairs of the voxels (``pair_tile``, ``pair_cell``
    int64, ascending by tile then cell) and each tile's smallest and largest
    voxel origin radius (``s0min``, ``s0max`` [NT] f32, from the float32
    expression sqrt((x^2 + y^2) + z^2), correctly rounded)."""
    from dxrvoxelizer_tpu_torch.utils import native

    tx, ty, tz = TILE
    nc = 6 * g * g
    cx, cy, cz = voxel_centers_norm(n)
    cells = native.dir_cells_native(n, g)  # the same bits, without [V, 3]
    if cells is None:
        pos = np.stack(np.meshgrid(cx, cy, cz, indexing="ij"),
                       axis=-1).reshape(-1, 3)
        cells = _dir_cells_host(pos, g)
        del pos
    key = torch.from_numpy(_tile_ids(n) * nc + cells)
    pairs = torch.unique(key.to(device))
    sq = torch.from_numpy(cx * cx).to(device)
    s0 = intersect.sqrt_rn((sq[:, None, None] + sq[None, :, None])
                           + sq[None, None, :])
    s0 = s0.reshape(n // tx, tx, n // ty, ty, n // tz, tz)
    return (pairs // nc, pairs % nc, s0.amin(dim=(1, 3, 5)).reshape(-1),
            s0.amax(dim=(1, 3, 5)).reshape(-1))


def _tile_union(n: int, g: int, cell_offs, cell_data, maxr, tri_bounds,
                ov_ids, device):
    """Per-tile candidate unions with the near drop (JAX's
    ``_tile_union_py``, as torch operations on ``device``) -> (tile_of,
    tri_of) int64, grouped by tile ascending and within a tile ordered by
    (``tri_bounds``, id); and the tiles' ``s0max``."""
    pair_tile, pair_cell, s0min, s0max = _tile_statics(n, g, str(device))

    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    offs_t, data_t = dev(cell_offs, np.int64), dev(cell_data, np.int64)
    maxr_t = dev(maxr, np.float32)
    reps = (offs_t[1:] - offs_t[:-1])[pair_cell]
    live = reps > 0
    pt, pc, reps = pair_tile[live], pair_cell[live], reps[live]
    total = int(reps.sum())
    # the CSR expansion: pair p takes cell_data[cell_offs[pc[p]] + j], j < reps[p]
    shift = torch.repeat_interleave(offs_t[pc] - (torch.cumsum(reps, 0) - reps),
                                    reps, output_size=total)
    tri = data_t[shift + torch.arange(total, device=device)]
    tl = torch.repeat_interleave(pt, reps, output_size=total)
    del shift
    alive = maxr_t[tri] >= s0min[tl]
    keys = [(tl[alive] << _ID_BITS) + tri[alive]]
    del tri, tl, alive
    if ov_ids.size:
        # near-origin triangles (their direction cone holds the origin) are
        # candidates of every tile, near drop included; doubles go below
        ov = dev(ov_ids, np.int64)
        tiles = torch.arange(s0min.shape[0], device=device)
        ov_alive = maxr_t[ov][None, :] >= s0min[:, None]
        keys.append(((tiles[:, None] << _ID_BITS) + ov[None, :])[ov_alive])
    key = torch.unique(torch.cat(keys))  # ascending by (tile, id)
    tile_of = key >> _ID_BITS
    tri_of = key & ((1 << _ID_BITS) - 1)
    # bounds are non-negative f32: their bits order as their values, so a
    # stable sort by (tile, bound bits) orders by (tile, bound, id)
    bits = dev(tri_bounds, np.float32).view(torch.int32).to(torch.int64)
    order = torch.sort((tile_of << 31) | bits[tri_of], stable=True).indices
    return tile_of[order], tri_of[order], s0max


def build_raystab_compact7(verts_norm, tris, n: int = 64,
                           gs: tuple | None = None, pad: float = 0.0,
                           pad_dirs=None) -> RaystabCompact7:
    """Binning + tile-union half of the gen-7 build: cone binning and fold
    (gen-6's), per-triangle radius bounds on the host; the tile union and
    the chunk bounds on ``verts_norm``'s device (the CPU for numpy).

    ``pad``/``pad_dirs`` follow gen-6's deformation contract
    (``raystab_fast.build_raystab_compact2``): the padded candidate sets and
    bounds stay conservative for every in-contract deformation, so the
    compact serves every frame and only the candidate rows are refitted."""
    if n % TILE[0]:
        raise ValueError(f"n={n} is not a multiple of the tile {TILE}")
    device = (verts_norm.device if isinstance(verts_norm, torch.Tensor)
              else torch.device("cpu"))
    gs = default_gs(n) if gs is None else gs
    tris_h, verts_h = _host(tris), _host_f32(verts_norm)
    dirs_h = None if pad_dirs is None else _host_f32(pad_dirs)
    t_count = int(tris_h.shape[0])
    assert t_count < 2**24, (
        f"{t_count} triangles exceed the 2^24 id range of the f32 id "
        "channel (reduce -subdiv or decimate the mesh)"
    )
    nt = n * n * n // 128
    empty = torch.zeros((0,), dtype=torch.int64, device=device)
    if t_count == 0:
        return RaystabCompact7(n=n, tids=empty,
                               offs=torch.zeros((1,), dtype=torch.int64,
                                                device=device),
                               ids=empty, bounds=None,
                               stats=Raystab7Stats(gs[0], 0, nt, 0, 0))

    sub_ids = np.arange(t_count, dtype=np.int32)
    level_runs = []
    for g in gs:
        if sub_ids.size == 0:
            break
        rects_h, over_h = _cone_keys_np(verts_h, tris_h[sub_ids], g, SPAN,
                                        pad, dirs_h)
        sorted_tris, starts, counts_h, ov_np = _cone_bins_host(
            rects_h, over_h, g, SPAN)
        level_runs.append((sub_ids[sorted_tris].astype(np.int64), starts,
                           counts_h.astype(np.int64), g))
        sub_ids = sub_ids[ov_np]
    g_fine = gs[0]
    cell_offs, cell_data = _fold_levels_csr(level_runs, g_fine)
    # f32 bounds, as in JAX's numpy and native passes
    maxr = _tri_maxr(verts_h, tris_h, pad).astype(np.float32)
    tri_bounds = _tri_minr(verts_h, tris_h, pad, dirs_h).astype(np.float32)
    tile_of, ids, s0max = _tile_union(n, g_fine, cell_offs, cell_data, maxr,
                                      tri_bounds, sub_ids, device)

    sizes_all = torch.bincount(tile_of, minlength=nt)
    tids = torch.nonzero(sizes_all).reshape(-1)
    sizes = sizes_all[tids]
    offs = torch.zeros((tids.shape[0] + 1,), dtype=torch.int64, device=device)
    torch.cumsum(sizes, 0, out=offs[1:])
    max_k = int(sizes.max()) if sizes.numel() else 0
    bounds = None
    if max_k > K_BLOCK:
        # chunk j's t lower bound: candidates ascend by their radius bound,
        # so the chunk's head carries its least; less the tile's largest
        # origin radius (with a margin, as _tri_maxr's)
        nb = -(-max_k // K_BLOCK)
        j = torch.arange(nb, device=device)
        head = offs[:-1, None] + j[None, :] * K_BLOCK
        has = (sizes[:, None] > j[None, :] * K_BLOCK) & (sizes[:, None] > K_BLOCK)
        tb_t = torch.from_numpy(tri_bounds).to(device)
        chunk_lo = tb_t[ids[torch.where(has, head, 0)]]
        one = torch.tensor(1.0 + 1e-6, dtype=torch.float32, device=device)
        eps = torch.tensor(1e-7, dtype=torch.float32, device=device)
        smax = s0max[tids] * one + eps
        bounds = torch.where(has, torch.clamp(chunk_lo - smax[:, None], min=0.0),
                             float("-inf"))
    stats = Raystab7Stats(g_fine=g_fine, live_tiles=int(tids.shape[0]),
                          dead_tiles=int(nt - tids.shape[0]),
                          pairs=int(ids.shape[0]),
                          near_origin=int(sub_ids.size))
    return RaystabCompact7(n=n, tids=tids, offs=offs, ids=ids,
                           bounds=bounds, stats=stats)


def _tile_vox_ids(tids: torch.Tensor, n: int) -> torch.Tensor:
    """Tile ids [L] -> the flat voxel id of each of their 128 lanes [L, 128]
    (x-major raster within the tile)."""
    tx, ty, tz = TILE
    bx = tids // ((n // ty) * (n // tz))
    r = tids % ((n // ty) * (n // tz))
    by, bz = r // (n // tz), r % (n // tz)
    lane = torch.arange(128, device=tids.device)
    lx, ly, lz = lane // (ty * tz), (lane // tz) % ty, lane % tz
    return ((bx[:, None] * tx + lx) * (n * n) + (by[:, None] * ty + ly) * n
            + (bz[:, None] * tz + lz))


def stream_ids7(compact: RaystabCompact7, device) -> dict:
    """The triangle id of every candidate row of the accel's strip stream
    ("main"): its rows are ``fused[ids]``."""
    return {"main": compact.ids.to(device)} if compact.tids.numel() else {}


def assemble_raystab_accel7(compact: RaystabCompact7, verts_norm, tris,
                            normals, by_id: bool = False) -> RaystabAccel7:
    """Device half of the gen-7 build: the live tiles as one strip stream
    (each tile's 128 rays, its CSR run of candidate rows, its chunk bounds),
    by torch gathers on the geometry's device. ``verts_norm``/``tris``/
    ``normals`` must be the geometry the compact was built from; the rows
    are gathers of gen-6's fused matrix, so they match the oracle's
    arithmetic bit for bit. ``by_id``: the stream holds that matrix and the
    row ids instead (``raystab_fast.stream_rows``; the refitter's form)."""
    dev = verts_norm.device
    n = compact.n
    tids = compact.tids.to(dev)
    p = int(compact.ids.shape[0])
    if p >= 2**31:
        raise ValueError(f"{p} candidate rows exceed the kernel's int32 "
                         "offsets (2^31): use a smaller grid or mesh")
    main = None
    if tids.numel():
        dirs, s0 = _ray_params(n, dev)
        dirs_p = torch.cat([dirs, torch.zeros((1, 3), dtype=dirs.dtype, device=dev)])
        s0_p = torch.cat([s0, torch.zeros((1,), dtype=s0.dtype, device=dev)])
        offs = compact.offs.to(dev)
        main = StripTables(
            rays=_strip_rays(_tile_vox_ids(tids, n), dirs_p, s0_p),
            cand_off=offs[:-1].to(torch.int32),
            cand_cnt=(offs[1:] - offs[:-1]).to(torch.int32),
            bounds=None if compact.bounds is None else compact.bounds.to(dev),
            **stream_rows(fused_coef_matrix(verts_norm, tris, normals),
                          stream_ids7(compact, dev)["main"], by_id),
        )
    return RaystabAccel7(n=n, t_count=int(tris.shape[0]), device=dev,
                         main=main, tids=tids,
                         slots=grid_cuda.tile_slots(tids, n),
                         stats=compact.stats)


def build_raystab_accel7(verts_norm, tris, normals, n: int = 64,
                         gs: tuple | None = None) -> RaystabAccel7:
    """Build the gen-7 accel once per geometry (the reference's AS build,
    Voxelizer.cpp:264-326): the compact on the geometry's device, then the
    strip stream."""
    compact = build_raystab_compact7(verts_norm, tris, n=n, gs=gs)
    return assemble_raystab_accel7(compact, verts_norm, tris, normals)


def untile7(accel: RaystabAccel7, ns: torch.Tensor | None):
    """The live tiles' channels ``ns`` [L, 128, 4] (None: no live tile) ->
    (occupancy [n,n,n] bool, rgba [n,n,n,4] f32): scattered into a zeroed
    tile buffer (dead tiles stay zero) and untiled by one permute (the
    plain version of X.6's untiling; the sharded frames' merge until they
    called X.6, kept as the chain the tests hold that route against)."""
    rgba = grid_cuda.untile_tiles_plain(ns, accel.tids, accel.n)
    return rgba[..., 3] != 0.0, rgba


def _fold7(accel: RaystabAccel7, threshold: float, rule: str,
           use_kernels: bool):
    """The fold + extraction over the live tiles -> their channels
    [L, 128, 4] (None when no tile is live)."""
    if accel.main is None:
        return None
    fold = (raystab_cuda.fold_extract if use_kernels
            else raystab_cuda.fold_extract_plain)
    return fold(accel.main, accel.t_count, threshold, rule)[2]


def raystab_query7(accel: RaystabAccel7, threshold: float = INSIDE_THRESHOLD,
                   rule: str = "backface", use_kernels: bool = True):
    """Per-frame trace -> (occupancy [n,n,n] bool, rgba [n,n,n,4] f32): one
    fold + extraction over the live tiles and the untiling X.6 with the
    rounding off (the kernels on a CUDA tensor, their plain versions on a
    CPU one, or with ``use_kernels=False``: the chain of :func:`untile7`).
    Ground truth is the radial oracle."""
    ns = _fold7(accel, threshold, rule, use_kernels)
    rgba = grid_cuda.untile(ns, accel.n, tiles=(accel.tids, accel.slots),
                            quantize=False, words=False, density=False,
                            use_kernel=use_kernels)[0]
    return rgba[..., 3] != 0.0, rgba


def raystab_grid7(accel: RaystabAccel7, threshold: float = INSIDE_THRESHOLD,
                  rule: str = "backface", quantize: bool = True,
                  gate: torch.Tensor | None = None, use_kernels: bool = True):
    """The query as the frame's grid -> (rgba [n,n,n,4], words [n,n,n/32]
    int32 or None, density [n,n,n] or None): the fold + extraction, then X.6
    untiles, rounds (``quantize``) and packs its output in one launch
    (``gate``: the ``-normals`` form, gated by those words; no words come
    out). The plain versions on a CPU tensor or with ``use_kernels=False``
    (``grid_cuda.untile_plain``: the density is then ``rgba[..., 3]``)."""
    ns = _fold7(accel, threshold, rule, use_kernels)
    return grid_cuda.untile(ns, accel.n, tiles=(accel.tids, accel.slots),
                            gate=gate, quantize=quantize,
                            use_kernel=use_kernels)


class RaystabTiledRefitter(RaystabRefitter):
    """Gen-7 deforming-mesh refitter: the padded compact built once from the
    rest pose, each frame's fused matrix read through the rest build's row
    ids (the contract and the API of :class:`~raystab_refit.RaystabRefitter`)."""

    def _compact(self, verts_rest, tris, gs, use_cache, cache_dir):
        if use_cache:
            from dxrvoxelizer_tpu_torch.utils.accel_cache import cached_compact7

            return cached_compact7(verts_rest, tris, self.n, gs, pad=self.pad,
                                   cache_dir=cache_dir, pad_dirs=self._pad_dirs)
        return build_raystab_compact7(verts_rest, tris, self.n, gs, pad=self.pad,
                                      pad_dirs=self._pad_dirs)

    _assemble = staticmethod(assemble_raystab_accel7)
