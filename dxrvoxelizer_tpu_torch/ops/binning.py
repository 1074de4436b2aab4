"""Triangle -> column-tile binning (the acceleration-structure build).

Port of ``dxrvoxelizer_tpu/ops/binning.py``. Instead of a BVH the triangles
are binned to the 32x32-column tiles their 2D projection may cover, with a
stable sort — no atomics, no variable-length buckets on the device:

1. per triangle, the conservative column range comes from the projected bbox
   (ops/geom.py); tiles are the range's 32x32 blocks;
2. triangles spanning <= ``max_span`` tiles per axis emit up to
   ``max_span^2`` (tile, tri) candidate pairs; a stable sort by tile id turns
   them into per-tile runs (the CSR analog);
3. rare huge triangles (span > max_span) go to a global overflow list that is
   appended to every tile — correctness never depends on the span cap;
4. per-tile runs are padded to a shared power-of-two capacity and the packed
   coefficients gathered into a dense [n_tiles, K, NCOEF] block for the
   parity kernel (ops/voxelize_cuda.py).

Beside the block the port gathers what the JAX package's TPU kernel has no
use for (it tests every column of a tile at once): each row's column span
[n_tiles, K, 4] int16 (the bounding box the triangle is binned by) and each
tile's count of real rows [n_tiles] int32 (its run plus the overflow rows),
on the device with no further host sync (:func:`bin_triangles_spans`). The
kernel walks only the real rows and tests each only on its span's columns.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from dxrvoxelizer_tpu_torch.ops.geom import parity_tri_setup
from dxrvoxelizer_tpu_torch.ops.voxelize_cuda import (
    NCOEF,
    TILE,
    pack_coeffs,
    tri_spans,
    voxelize_parity_tiles,
)


@dataclass
class BinStats:
    n_tiles: int
    capacity: int  # per-tile padded triangle capacity (incl. overflow)
    max_bin: int  # largest per-tile bin before padding
    overflow: int  # triangles routed to every tile


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _bin_phase_a(verts_norm, tris, n: int, max_span: int):
    """Phase A: setup, candidate pairs, sort, per-tile runs (device only)."""
    device = verts_norm.device
    pt = parity_tri_setup(verts_norm, tris, n)
    coef = pack_coeffs(pt)  # [T, NCOEF]
    t_count = coef.shape[0]
    nt = n // TILE
    n_tiles = nt * nt

    # covered column range from the projected bbox
    x0 = torch.ceil(pt.xmin)
    x1 = torch.floor(pt.xmax)
    y0 = torch.ceil(pt.ymin)
    y1 = torch.floor(pt.ymax)
    nonempty = (
        (pt.valid > 0) & (x1 >= x0) & (y1 >= y0)
        & (x1 >= 0) & (x0 <= n - 1) & (y1 >= 0) & (y0 <= n - 1)
    )

    def tile_of(v):
        return torch.clamp(v, 0, n - 1).to(torch.int64) // TILE

    tx0, tx1, ty0, ty1 = tile_of(x0), tile_of(x1), tile_of(y0), tile_of(y1)
    span_x = tx1 - tx0 + 1
    span_y = ty1 - ty0 + 1
    small = nonempty & (span_x <= max_span) & (span_y <= max_span)
    overflow_mask = nonempty & ~small

    # candidate (tile, tri) pairs for the max_span^2 offsets
    cands = []
    for dx in range(max_span):
        for dy in range(max_span):
            tid = (tx0 + dx) * nt + (ty0 + dy)
            ok = small & (dx < span_x) & (dy < span_y)
            cands.append(torch.where(ok, tid, n_tiles))  # sentinel = n_tiles
    keys = torch.stack(cands, dim=0).reshape(-1)  # [S*T]
    tri_ids = torch.arange(t_count, device=device).repeat(max_span * max_span)

    sorted_keys, order = torch.sort(keys, stable=True)
    sorted_tris = tri_ids[order]

    starts = torch.searchsorted(
        sorted_keys, torch.arange(n_tiles + 1, device=device)
    )
    counts = starts[1:] - starts[:-1]  # [n_tiles]
    # overflow triangle ids first (in id order), then -1 — sync-free
    ov_order = torch.sort((~overflow_mask).to(torch.uint8), stable=True)[1]
    ov_ids = torch.where(overflow_mask[ov_order], ov_order, -1)
    return (
        coef, sorted_tris, starts, counts, ov_ids,
        counts.max(), overflow_mask.sum(), tri_spans(pt, n),
    )


def _bin_phase_b(coef, sorted_tris, starts, counts, ov_ids, n_overflow: int,
                 cap: int, spans):
    """Phase B: padded per-tile index matrix + coefficient and span gather
    -> (coef_tiles [n_tiles, cap, NCOEF], spans [n_tiles, cap, 4] int16,
    real rows per tile [n_tiles] int32)."""
    t_count = coef.shape[0]
    j = torch.arange(cap, device=coef.device)[None, :]
    in_run = j < counts[:, None]
    run_idx = torch.clamp(starts[:-1][:, None] + j, 0, sorted_tris.shape[0] - 1)
    idx = torch.where(in_run, sorted_tris[run_idx], -1)
    # overflow triangles appended to every tile
    ov_slot = j - counts[:, None]
    in_ov = (ov_slot >= 0) & (ov_slot < n_overflow)
    ov_idx = torch.clamp(ov_slot, 0, t_count - 1)
    idx = torch.where(in_ov, ov_ids[ov_idx], idx)

    # gather coefficients; index -1 -> zero row (valid=0 kills the triangle)
    coef_padded = torch.cat(
        [coef, torch.zeros((1, NCOEF), dtype=coef.dtype, device=coef.device)]
    )
    # (-1, -1, -1, -1) on padding rows, as in the work queue
    spans_padded = torch.cat([spans, spans.new_full((1, 4), -1)])
    gather = torch.where(idx < 0, t_count, idx)
    return (coef_padded[gather], spans_padded[gather],
            (counts + n_overflow).to(torch.int32))


def bin_triangles_spans(
    verts_norm: torch.Tensor,
    tris: torch.Tensor,
    n: int,
    max_span: int = 3,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, BinStats]:
    """:func:`bin_triangles` with each row's column span and each tile's real
    rows -> (coef_tiles [n_tiles, K, NCOEF], spans [n_tiles, K, 4] int16,
    counts [n_tiles] int32, stats); the kernel's inputs."""
    nt = n // TILE
    n_tiles = nt * nt
    (coef, sorted_tris, starts, counts, ov_ids, max_bin_d, n_ov_d,
     spans) = _bin_phase_a(verts_norm, tris, n, max_span)
    max_bin, n_overflow = (int(v) for v in torch.stack([max_bin_d, n_ov_d]).tolist())

    cap_small = max(_round_up(max_bin, 8), 8)
    cap = cap_small + _round_up(max(n_overflow, 0), 8)
    cap_b = 8
    while cap_b < cap:
        cap_b *= 2
    cap = cap_b

    coef_tiles, span_tiles, row_counts = _bin_phase_b(
        coef, sorted_tris, starts, counts, ov_ids, n_overflow, cap, spans
    )
    stats = BinStats(
        n_tiles=n_tiles, capacity=cap, max_bin=max_bin, overflow=n_overflow
    )
    return coef_tiles, span_tiles, row_counts, stats


def bin_triangles(
    verts_norm: torch.Tensor,
    tris: torch.Tensor,
    n: int,
    max_span: int = 3,
) -> tuple[torch.Tensor, BinStats]:
    """Build the dense binned coefficient block -> ([n_tiles, K, NCOEF], stats).

    Two phases with a single host sync between them (the padded capacity is
    data-dependent). Capacity is bucketed to powers of two so the kernel
    shape is stable across frames of a deforming mesh.
    """
    coef_tiles, _, _, stats = bin_triangles_spans(verts_norm, tris, n, max_span)
    return coef_tiles, stats


class StaticBinnedVoxelizer:
    """Build-once / dispatch-per-frame wrapper of the binned parity kernel.

    ``bin_triangles`` (and its one host sync) runs once at construction; per
    frame only the parity kernel launches — the reference's build-AS-once +
    per-frame DispatchRays split (Content/Voxelizer.cpp:264-326 vs :351-369).
    """

    def __init__(self, verts_norm: torch.Tensor, tris: torch.Tensor, n: int):
        self.n = n
        (self.coef_tiles, self.spans, self.counts,
         self.stats) = bin_triangles_spans(verts_norm, tris, n)

    def __call__(self) -> torch.Tensor:
        """-> packed occupancy words [N, N, N//32] (asynchronous on CUDA)."""
        return voxelize_parity_tiles(self.coef_tiles, self.n, spans=self.spans,
                                     counts=self.counts)


def voxelize_parity_binned(verts_norm: torch.Tensor, tris: torch.Tensor,
                           n: int) -> torch.Tensor:
    """Binned path -> packed occupancy words [N, N, N//32]."""
    if tris.shape[0] == 0:
        return torch.zeros((n, n, n // 32), dtype=torch.int32,
                           device=verts_norm.device)
    return StaticBinnedVoxelizer(verts_norm, tris, n)()
