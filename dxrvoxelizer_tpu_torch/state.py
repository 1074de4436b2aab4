"""State carried across from the JAX package.

The two packages share no objects: the JAX package's arrays, taken to the
host as numpy, become this package's tensors here, so both compute on
identical inputs (the tests compare them this way): mesh buffers, packed
occupancy grids, work queues built by the JAX package's ``build_queue``,
compact ray-stab accels built by its ``build_raystab_compact2`` (gen-6) and
``build_raystab_compact7`` (gen-7), and gen-1 ray-stab accels built by its
``build_raystab_accel``.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from dxrvoxelizer_tpu_torch.core.pipeline import VoxelGrid
from dxrvoxelizer_tpu_torch.models.mesh import MeshBuffers
from dxrvoxelizer_tpu_torch.ops.raystab_fast import (
    RadialBinStats,
    Raystab2Stats,
    RaystabAccel,
    RaystabCompact2,
    assemble_raystab_accel,
)
from dxrvoxelizer_tpu_torch.ops.raystab_cuda import K_BLOCK
from dxrvoxelizer_tpu_torch.ops.raystab_tiled import (
    Raystab7Stats,
    RaystabCompact7,
)
from dxrvoxelizer_tpu_torch.ops.voxelize_cuda import NCOEF

MESH_FIELDS = ("positions", "normals", "tris", "positions_norm")


def mesh_buffers_from_numpy(d: Mapping[str, np.ndarray],
                            device: torch.device | str) -> MeshBuffers:
    """``MeshBuffers`` from the JAX ``MeshBuffers`` fields as numpy arrays
    (``{f: np.asarray(getattr(mb, f)) for f in MESH_FIELDS}``)."""
    return MeshBuffers(
        positions=torch.tensor(np.asarray(d["positions"], np.float32)).to(device),
        normals=torch.tensor(np.asarray(d["normals"], np.float32)).to(device),
        tris=torch.tensor(np.asarray(d["tris"], np.int64)).to(device),
        positions_norm=torch.tensor(
            np.asarray(d["positions_norm"], np.float32)
        ).to(device),
    )


def grid_from_numpy(words: np.ndarray, device: torch.device | str) -> VoxelGrid:
    """``VoxelGrid`` from packed occupancy words [N, N, N//32] int32."""
    w = np.asarray(words)
    if w.dtype != np.int32 or w.ndim != 3 or w.shape[2] * 32 != w.shape[0]:
        raise ValueError(f"expected int32 words [N, N, N//32], got {w.dtype} {w.shape}")
    return VoxelGrid(words=torch.tensor(w).to(device))


def queue_from_numpy(coefs: np.ndarray, chunk_tile: np.ndarray,
                     chunk_nsub: np.ndarray, chunk_last: np.ndarray, n: int,
                     device: torch.device | str):
    """A work queue built by the JAX package's ``build_queue`` (its arrays as
    numpy) -> ``(coefs, chunk_tile, chunk_nsub, chunk_last)`` tensors that
    ``ops.voxelize_queue_cuda.voxelize_parity_queue_chunks`` (the kernel, or
    its plain version on the CPU) takes for an ``n``^3 grid, without column
    spans (the kernel then tests every column of each row's tile)."""
    c = np.asarray(coefs, np.float32)
    chunks = [np.asarray(a) for a in (chunk_tile, chunk_nsub, chunk_last)]
    num_chunks = chunks[0].shape[0]
    if n % 32 != 0 or c.ndim != 2 or c.shape[1] != NCOEF \
            or c.shape[0] % max(num_chunks, 1) != 0:
        raise ValueError(f"expected coefs [num_chunks * k_chunk, {NCOEF}] for "
                         f"n % 32 == 0, got {c.shape} with {num_chunks} chunks")
    if any(a.shape != (num_chunks,) for a in chunks):
        raise ValueError("chunk_tile, chunk_nsub and chunk_last must be "
                         f"[{num_chunks}]")
    tile, nsub = (chunks[i].astype(np.int64) for i in (0, 1))
    if (np.diff(tile) < 0).any() or (
            (tile[1:] == tile[:-1]) & (nsub[:-1] <= 0) & (nsub[1:] > 0)).any():
        raise ValueError("chunk_tile must be non-decreasing, and a tile's "
                         "chunks with no live row must follow its others (as "
                         "build_queue lays them out)")
    return (torch.tensor(c).to(device),
            *(torch.tensor(a.astype(np.int32)).to(device) for a in chunks))


def raystab_compact_from_numpy(n: int, classes, ov_ids, levels: tuple = (),
                               near_origin: int | None = None) -> RaystabCompact2:
    """A compact ray-stab accel built by the JAX package's
    ``build_raystab_compact2`` (``classes`` of (rt128, tab, bounds-or-None)
    and ``ov_ids``, as numpy) -> the port's :class:`RaystabCompact2`, which
    ``ops.raystab_fast.assemble_raystab_accel2`` expands on the port's device
    from the same geometry. The TPU's row padding (strips without a ray) and
    the -1 padding of ``ov_ids`` are dropped."""
    out = []
    for rt128, tab, bounds in classes:
        rt = np.asarray(rt128, np.int32)
        tb = np.asarray(tab, np.int32)
        if rt.ndim != 2 or rt.shape[1] != 128 or tb.shape[0] != rt.shape[0]:
            raise ValueError(f"expected rt128 [VC, 128] and tab [VC, K], got "
                             f"{rt.shape} and {tb.shape}")
        keep = (rt >= 0).any(axis=1)
        b = None if bounds is None else np.asarray(bounds, np.float32)[keep]
        out.append((rt[keep], tb[keep], b))
    ov = None
    if ov_ids is not None:
        o = np.asarray(ov_ids, np.int32)
        ov = o[o >= 0] if (o >= 0).any() else None
    if near_origin is None:
        near_origin = 0 if ov is None else int(ov.size)
    return RaystabCompact2(n=n, classes=tuple(out), ov_ids=ov,
                           stats=Raystab2Stats(levels=tuple(levels),
                                               near_origin=near_origin))


def raystab_compact7_from_numpy(n: int, classes, g_fine: int = 0,
                                near_origin: int = 0,
                                device: torch.device | str = "cpu"
                                ) -> RaystabCompact7:
    """A gen-7 compact built by the JAX package's ``build_raystab_compact7``
    (``classes`` of (tids [VC], tab [VC, K], bounds [VC, K/256] or None), as
    numpy) -> the port's :class:`RaystabCompact7` on ``device``, which
    ``ops.raystab_tiled.assemble_raystab_accel7`` expands from the same
    geometry. The class split and the padding (tiles -1, ids -1) are dropped:
    the live tiles in ascending order, each with its candidates in the
    class table's order and the bounds of its own chunks (-inf elsewhere)."""
    rows = []  # (tile id, candidate ids, chunk bounds or None)
    for tids, tab, bounds in classes:
        tids, tab = np.asarray(tids, np.int64), np.asarray(tab, np.int64)
        if tab.ndim != 2 or tab.shape[0] != tids.shape[0]:
            raise ValueError(f"expected tids [VC] and tab [VC, K], got "
                             f"{tids.shape} and {tab.shape}")
        for r in np.flatnonzero(tids >= 0):
            ids = tab[r][tab[r] >= 0]
            b = None
            if bounds is not None:
                b = np.asarray(bounds, np.float32)[r, :-(-ids.size // K_BLOCK)]
            rows.append((int(tids[r]), ids, b))
    rows.sort(key=lambda x: x[0])
    sizes = np.array([x[1].size for x in rows], np.int64)
    offs = np.zeros((len(rows) + 1,), np.int64)
    np.cumsum(sizes, out=offs[1:])
    bounds = None
    if any(x[2] is not None for x in rows):
        bounds = np.full((len(rows), max(x[2].size for x in rows if x[2] is not None)),
                         -np.inf, np.float32)
        for i, (_, _, b) in enumerate(rows):
            if b is not None:
                bounds[i, :b.size] = b
    nt = n * n * n // 128

    def dev(a):
        return torch.from_numpy(a).to(device)

    return RaystabCompact7(
        n=n, tids=dev(np.array([x[0] for x in rows], np.int64)),
        offs=dev(offs),
        ids=dev(np.concatenate([x[1] for x in rows] or [np.zeros(0, np.int64)])),
        bounds=None if bounds is None else dev(bounds),
        stats=Raystab7Stats(g_fine, len(rows), nt - len(rows), int(offs[-1]),
                            near_origin))


def raystab_accel_from_numpy(verts_norm: torch.Tensor, tris: torch.Tensor,
                             n: int, g: int, classes, ov_ids,
                             stats: Mapping[str, int]) -> RaystabAccel:
    """A gen-1 accel built by the JAX package's ``build_raystab_accel`` -> the
    port's :class:`RaystabAccel` on ``verts_norm``'s device, from the same
    geometry. ``classes``: its capacity classes as numpy, each (cell_table
    [Cc, K], ray_table [Cc, R], ...); a row is one direction cell, its
    candidate ids and ray ids padded with -1. ``ov_ids``: its overflow ids
    (-1 padded); ``stats``: its stats' fields. The padding, the cell-chunk
    rows without rays and the class split are dropped; rays of cells outside
    every class test no candidate, as there."""
    rays, ray_n, cands, cand_n = [], [], [], []
    for cell_table, ray_table, *_ in classes:
        ct, rt = np.asarray(cell_table), np.asarray(ray_table)
        if ct.shape[0] != rt.shape[0]:
            raise ValueError(f"cell and ray tables disagree: {ct.shape} {rt.shape}")
        rays.append(rt[rt >= 0])
        ray_n.append((rt >= 0).sum(axis=1))
        cands.append(ct[ct >= 0])
        cand_n.append((ct >= 0).sum(axis=1))

    def csr(parts, counts):
        off = np.zeros((sum(c.size for c in counts) + 1,), np.int64)
        if counts:
            np.cumsum(np.concatenate(counts), out=off[1:])
        data = np.concatenate(parts) if parts else np.zeros((0,), np.int32)
        return data.astype(np.int32), off

    ray_ids, ray_off = csr(rays, ray_n)
    cand_ids, cand_off = csr(cands, cand_n)
    ov = np.asarray(ov_ids, np.int32)
    return assemble_raystab_accel(verts_norm, tris, n, g,
                                  (ray_ids, ray_off, cand_ids, cand_off),
                                  ov[ov >= 0], RadialBinStats(**stats))
