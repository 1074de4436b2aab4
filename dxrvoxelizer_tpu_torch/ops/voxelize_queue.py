"""Work-queue parity voxelizer: the >= 128^3 path and the deforming-mesh path.

Port of ``dxrvoxelizer_tpu/ops/voxelize_queue.py``. Triangles are binned to
16x8-column tiles, and each tile's triangles are laid out back to back as
chunks of ``k_chunk`` packed coefficient rows in one flat queue; three
per-chunk arrays name the chunk's tile (``chunk_tile``), its live sub-blocks
of 8 rows (``chunk_nsub``) and whether it is the tile's last chunk
(``chunk_last``). Empty tiles get no chunks. Beside the rows, ``spans``
[rows, 4] int16 holds each row's column span, the bounding box the binning
uses (``[ceil xmin, floor xmax] x [ceil ymin, floor ymax]``, clipped to
[-1, N]; padding rows get (-1, -1, -1, -1)); not in the JAX package, whose
TPU kernel tests all 128 columns of a tile at once. The kernel
(ops/voxelize_queue_cuda.py, ``csrc/parity_queue.cu``) turns the queue into
packed occupancy words, bit-identical to the binned path and the oracle,
testing each row only on its span widened by one column (the whole tile for
a sliver; ``voxelize_queue_cuda.row_columns``).

- :func:`build_queue`: device phase A (setup, candidate pairs, one sort into
  per-tile runs), ONE host sync for the per-tile counts that size the
  queue, then the device build's window assembly and coefficient gather.
- :class:`StaticVoxelizer`: build once, per frame only the kernel.
- :class:`DeformingVoxelizer`: per frame, the whole queue is rebuilt on the
  device at a fixed capacity with no host sync (``check=True`` asks for one).

Not carried over, because they are TPU machinery: the VMEM output budget and
its tile groups (``VMEM_OUT_BUDGET``, ``_output_groups``,
``_prepare_queue_groups``, ``_run_queue_groups``,
``voxelize_parity_queue_run``, ``_build_queue_device_groups``) — on the card
one launch covers every tile at every N; ``CHUNKS_PER_STEP`` and
``static_trip``, which amortise per-grid-step cost and loop overhead on the
TPU; and the ``perturb`` anti-hoist hook of the TPU benchmark.

Phase A sorts the int64 key ``tile * T + tri``, which gives the JAX
package's packed-key order (tri-ascending within a tile), so queue rows
compare one for one. (The JAX package falls back to a slot-major tuple sort
only when tile and triangle ids do not fit 32 bits together; the words do
not depend on the order, XOR being commutative.)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dxrvoxelizer_tpu_torch.ops.geom import parity_tri_setup
from dxrvoxelizer_tpu_torch.ops.voxelize_cuda import NCOEF, pack_coeffs
from dxrvoxelizer_tpu_torch.ops.voxelize_queue_cuda import (
    K_CHUNK,
    SUB,
    TILE_X,
    TILE_Y,
    voxelize_parity_queue_chunks,
)

OV_CAP_DEVICE = 512  # static overflow-list capacity of the device build
HEADROOM = 1.5  # deforming capacity: the rest pose's chunks x HEADROOM
SPAN_CAP = (4, 8)  # tile-span caps (x, y); wider triangles go to overflow


@dataclass
class QueueStats:
    n_tiles: int
    num_chunks: int  # padded queue length (the kernel's grid)
    real_chunks: int
    pairs: int  # (tile, triangle) pairs before chunk padding
    overflow: int  # triangles appended to every tile


def suffix_parity_words(words: torch.Tensor) -> torch.Tensor:
    """Crossing-bit field -> occupancy: bit k := parity of bits >= k.

    ``words``: int32 [..., W, lanes] with the word axis second-to-last
    (z-minor packing). The torch reference of the conversion the kernel does
    in place. Exact integer parity, in int64 so the shifts are logical.
    """
    s = words.to(torch.int64) & 0xFFFFFFFF
    for sh in (1, 2, 4, 8, 16):  # within-word suffix parity
        s = s ^ (s >> sh)
    # carry: parity of all bits in strictly-higher words, spread to 32 bits
    par = s & 1  # full-word parity
    carry = (par.flip(-2).cumsum(-2).flip(-2) - par) & 1
    out = s ^ (carry * 0xFFFFFFFF)
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


def _queue_phase_a(verts_norm, tris, n: int, max_span_x: int,
                   max_span_y: int, ov_cap: int | None = None):
    """Device phase A: setup, (tile, tri) pairs, sort -> per-tile runs.

    Sync-free. ``ov_cap`` bounds the size of the overflow id list (None ->
    T, always enough); ids past the true overflow count are -1. The last
    output is every triangle's column span [T, 4] int16 (x_lo, x_hi, y_lo,
    y_hi): the columns it is binned by, clipped to [-1, n].
    """
    device = verts_norm.device
    pt = parity_tri_setup(verts_norm, tris, n)
    coef = pack_coeffs(pt)  # [T, NCOEF]
    t_count = coef.shape[0]
    nty = n // TILE_Y
    n_tiles = (n // TILE_X) * nty

    x0 = torch.ceil(pt.xmin)
    x1 = torch.floor(pt.xmax)
    y0 = torch.ceil(pt.ymin)
    y1 = torch.floor(pt.ymax)
    nonempty = (
        (pt.valid > 0) & (x1 >= x0) & (y1 >= y0)
        & (x1 >= 0) & (x0 <= n - 1) & (y1 >= 0) & (y0 <= n - 1)
    )

    def col(v):
        return torch.clamp(v, 0, n - 1).to(torch.int64)

    tx0, tx1 = col(x0) // TILE_X, col(x1) // TILE_X
    ty0, ty1 = col(y0) // TILE_Y, col(y1) // TILE_Y
    span_x = tx1 - tx0 + 1
    span_y = ty1 - ty0 + 1
    small = nonempty & (span_x <= max_span_x) & (span_y <= max_span_y)
    overflow_mask = nonempty & ~small

    cands = []
    for dx in range(max_span_x):
        for dy in range(max_span_y):
            tid = (tx0 + dx) * nty + (ty0 + dy)
            ok = small & (dx < span_x) & (dy < span_y)
            cands.append(torch.where(ok, tid, n_tiles))  # sentinel = n_tiles
    keys = torch.stack(cands, dim=0).reshape(-1)
    tri_ids = torch.arange(t_count, device=device).repeat(max_span_x * max_span_y)
    # one sort of unique int64 keys: tile-major, tri-ascending within a tile
    t_mul = max(t_count, 1)
    sorted_keys = torch.sort(keys * t_mul + tri_ids)[0]
    sorted_tris = sorted_keys % t_mul
    starts = torch.searchsorted(
        sorted_keys, torch.arange(n_tiles + 1, device=device) * t_mul
    )
    counts = starts[1:] - starts[:-1]
    # overflow triangle ids first (in id order), then -1 — sync-free
    o_cap = max(t_count if ov_cap is None else min(ov_cap, t_count), 1)
    ov_order = torch.sort((~overflow_mask).to(torch.uint8), stable=True)[1]
    ov_order = ov_order[:o_cap]
    ov_ids = torch.where(overflow_mask.index_select(0, ov_order), ov_order, -1)
    spans = torch.clamp(torch.stack([x0, x1, y0, y1], dim=1), -1, n).to(torch.int16)
    return (coef, sorted_tris, starts, counts, ov_ids, overflow_mask.sum(),
            spans)


def _gather_coefs(coef, spans, sorted_tris, ov_ids, rows):
    """Coefficient rows and column spans of the virtual [sorted_tris | ov_ids
    | sentinel] concatenation at ``rows`` (-1 -> a zero row, an empty
    span)."""
    t_count = coef.shape[0]
    combined = torch.cat([
        sorted_tris, ov_ids.to(sorted_tris.dtype),
        torch.full((1,), -1, dtype=sorted_tris.dtype, device=coef.device),
    ])
    tri_id = combined.index_select(0, torch.clamp(rows, 0, combined.shape[0] - 1))
    tri_id = torch.where(rows < 0, t_count, tri_id)
    coef_padded = torch.cat(
        [coef, torch.zeros((1, NCOEF), dtype=coef.dtype, device=coef.device)]
    )
    # (-1, -1, -1, -1) on padding rows (their zero rows test nothing)
    spans_padded = torch.cat([spans, torch.full(
        (1, 4), -1, dtype=spans.dtype, device=coef.device)])
    return (coef_padded.index_select(0, tri_id),
            spans_padded.index_select(0, tri_id))


def build_queue(verts_norm: torch.Tensor, tris: torch.Tensor, n: int,
                max_span_x: int = SPAN_CAP[0], max_span_y: int = SPAN_CAP[1]):
    """Build the flat work queue -> (coefs, spans, chunk_tile, chunk_nsub,
    chunk_last, stats).

    One host sync (the per-tile counts) sizes the queue: the chunk count,
    bucketed to multiples of 128, and the stats. The layout itself is the
    device build's (:func:`_assemble_window`) at that exact capacity.
    """
    pa = _queue_phase_a(verts_norm, tris, n, max_span_x, max_span_y)
    counts, n_ov_d = pa[3], pa[5]
    host = torch.cat([counts, n_ov_d.reshape(1)]).cpu().numpy()  # the sync
    counts_h, n_ov = host[:-1].astype(np.int64), int(host[-1])
    # overflow triangles may cover any column, so with any overflow present
    # every tile gets a run; otherwise empty tiles get no chunks at all
    per_tile = np.where((counts_h > 0) | (n_ov > 0), counts_h + n_ov, 0)
    real_chunks = int(((per_tile + K_CHUNK - 1) // K_CHUNK).sum())
    num_chunks = max(-(-real_chunks // 128) * 128, 128)
    *queue, _ = _assemble_window(pa, n, num_chunks)
    stats = QueueStats(
        n_tiles=counts_h.shape[0], num_chunks=num_chunks,
        real_chunks=real_chunks, pairs=int(per_tile.sum()), overflow=n_ov,
    )
    return (*queue, stats)


class StaticVoxelizer:
    """Build-once / dispatch-per-frame parity voxelizer for STATIC meshes.

    The reference builds its acceleration structure once at init
    (Content/Voxelizer.cpp:264-326) and per frame only re-dispatches rays
    (:351-369). ``build_queue`` (device sort + one host sync) runs once
    here; ``__call__`` is one kernel launch — no host sync, no layout work.
    """

    def __init__(self, verts_norm: torch.Tensor, tris: torch.Tensor, n: int):
        self.n = n
        (self.coefs, self.spans, self.chunk_tile, self.chunk_nsub,
         self.chunk_last, self.stats) = build_queue(verts_norm, tris, n)

    def __call__(self) -> torch.Tensor:
        """-> packed occupancy words [N, N, N//32] (asynchronous on CUDA)."""
        return voxelize_parity_queue_chunks(
            self.coefs, self.chunk_tile, self.chunk_nsub, self.n,
            spans=self.spans)


def voxelize_parity_queue(verts_norm: torch.Tensor, tris: torch.Tensor,
                          n: int) -> torch.Tensor:
    """Bin + run: the hi-res (>= 128^3) parity voxelizer -> [N, N, N//32]."""
    if n % 32 != 0:
        raise ValueError(f"grid size must be a multiple of 32, got {n}")
    if tris.shape[0] == 0:
        return torch.zeros((n, n, n // 32), dtype=torch.int32,
                           device=verts_norm.device)
    return StaticVoxelizer(verts_norm, tris, n)()


# ---- deforming-mesh path: device-only queue build ---------------------------

def _assemble_window(phase_a_out, n: int, num_chunks: int, tile_lo: int = 0,
                     tile_hi: int | None = None):
    """Assemble the queue of the tiles ``[tile_lo, tile_hi)`` (default: every
    tile) from phase-A results at a fixed capacity.

    Sync-free: returns (coefs, spans, chunk_tile, chunk_nsub, chunk_last,
    ok) as device tensors; ``chunk_tile`` holds global tile ids (padding
    chunks name the last tile and hold no live row). ``ok`` is False when
    the queue needs more than ``num_chunks`` chunks or the overflow count
    exceeds phase A's ov_ids capacity (either way the queue is truncated;
    grow and retry).
    """
    k_chunk = K_CHUNK
    nty = n // TILE_Y
    n_tiles = (n // TILE_X) * nty
    coef, sorted_tris, starts, counts, ov_ids, n_ov, spans = phase_a_out
    device = coef.device

    tile_idx = torch.arange(n_tiles, device=device)
    in_window = (tile_idx >= tile_lo) & (tile_idx < (
        n_tiles if tile_hi is None else tile_hi))
    per_tile = torch.where(in_window & ((counts > 0) | (n_ov > 0)),
                           counts + n_ov, 0)
    cpt = (per_tile + k_chunk - 1) // k_chunk  # chunks per tile
    bounds = torch.cumsum(cpt, 0)  # end chunk (exclusive) per tile
    first_chunk = bounds - cpt
    total_chunks = bounds[-1]
    ok = (total_chunks <= num_chunks) & (n_ov <= ov_ids.shape[0])

    # chunk j -> tile: repeat-via-searchsorted on the chunk cumsum
    j = torch.arange(num_chunks, device=device)
    tile_of = torch.searchsorted(bounds, j, right=True)
    valid_chunk = j < total_chunks
    tile_of = torch.where(valid_chunk, torch.clamp(tile_of, max=n_tiles - 1),
                          n_tiles - 1)
    within = j - first_chunk.index_select(0, tile_of)
    remaining = per_tile.index_select(0, tile_of) - within * k_chunk
    nsub = torch.where(
        valid_chunk, (torch.clamp(remaining, 0, k_chunk) + SUB - 1) // SUB, 0
    ).to(torch.int32)
    last = (valid_chunk & (within == cpt.index_select(0, tile_of) - 1)
            ).to(torch.int32)

    # slot -> row of [sorted_tris | ov_ids | sentinel], per-chunk values
    # broadcast over the k_chunk axis
    s_total = sorted_tris.shape[0]
    chunk_start = starts[:-1].index_select(0, tile_of)[:, None]  # [chunks, 1]
    cnt = counts.index_select(0, tile_of)[:, None]
    kk = torch.arange(k_chunk, device=device)[None, :]
    t_idx = torch.where(valid_chunk[:, None], (within * k_chunk)[:, None] + kk, -1)
    in_run = (t_idx >= 0) & (t_idx < cnt)
    in_ov = (t_idx >= cnt) & (t_idx < cnt + n_ov)
    rows = torch.where(
        in_run, chunk_start + t_idx,
        torch.where(in_ov, s_total + (t_idx - cnt), -1),
    ).reshape(-1)
    coefs, row_spans = _gather_coefs(coef, spans, sorted_tris, ov_ids, rows)
    return coefs, row_spans, tile_of.to(torch.int32), nsub, last, ok


def _build_queue_device(verts_norm, tris, n: int, num_chunks: int,
                        max_span_x: int, max_span_y: int, tile_lo: int = 0,
                        tile_hi: int | None = None):
    """Fully-on-device queue build (no host sync) for per-frame rebinning,
    of the tiles ``[tile_lo, tile_hi)`` (a rank's tile group,
    parallel/shard.py; default every tile)."""
    pa = _queue_phase_a(verts_norm, tris, n, max_span_x, max_span_y,
                        ov_cap=OV_CAP_DEVICE)
    return _assemble_window(pa, n, num_chunks, tile_lo, tile_hi)


def rest_mesh_spans(verts_norm: torch.Tensor, tris: torch.Tensor,
                    n: int) -> tuple:
    """Tile-span caps (span_x, span_y) covering every triangle of the REST
    mesh, clamped to ``SPAN_CAP`` (larger rest spans route through overflow).

    The device build's sort scales with span_x * span_y * T candidate rows,
    and real meshes at hi-res grids span 1-2 tiles per axis. Deformed
    frames whose triangles outgrow the caps fall into the exact overflow
    path and, past ``OV_CAP_DEVICE`` of them, clear ``ok``.
    """
    pt = parity_tri_setup(verts_norm, tris, n)
    x0, x1, y0, y1 = (v.cpu().numpy() for v in (
        torch.ceil(pt.xmin), torch.floor(pt.xmax),
        torch.ceil(pt.ymin), torch.floor(pt.ymax),
    ))
    valid = (pt.valid > 0).cpu().numpy()
    ne = valid & (x1 >= x0) & (y1 >= y0) & (x1 >= 0) & (x0 <= n - 1) \
        & (y1 >= 0) & (y0 <= n - 1)
    if not ne.any():
        return (1, 1)
    tx0 = np.clip(x0, 0, n - 1).astype(np.int64) // TILE_X
    tx1 = np.clip(x1, 0, n - 1).astype(np.int64) // TILE_X
    ty0 = np.clip(y0, 0, n - 1).astype(np.int64) // TILE_Y
    ty1 = np.clip(y1, 0, n - 1).astype(np.int64) // TILE_Y
    sx = int((tx1 - tx0 + 1)[ne].max())
    sy = int((ty1 - ty0 + 1)[ne].max())
    return (min(sx, SPAN_CAP[0]), min(sy, SPAN_CAP[1]))


class DeformingVoxelizer:
    """Per-frame re-bin + voxelize with zero host syncs after warm-up.

    The reference rebuilds nothing per frame (static AS) but re-voxelizes;
    the BASELINE.json deforming configuration re-bins too. The chunk
    capacity is sized from the rest mesh (x ``HEADROOM``); a frame that
    overflows it clears the ``ok`` word, and ``check=True`` raises on it
    (grow and retry by constructing a new instance).
    """

    def __init__(self, verts_norm: torch.Tensor, tris: torch.Tensor, n: int):
        # span caps from the rest mesh: the sort scales with span_x*span_y*T
        self.spans = rest_mesh_spans(verts_norm, tris, n)
        *_, stats = build_queue(verts_norm, tris, n, max_span_x=self.spans[0],
                                max_span_y=self.spans[1])
        cap = int(stats.real_chunks * HEADROOM) + 8
        self.num_chunks = -(-cap // 128) * 128
        self.n = n
        self.tris = tris

    def build(self, verts_norm: torch.Tensor):
        """Deformed vertices -> the device queue (coefs, spans, chunk_tile,
        chunk_nsub, chunk_last, ok), with no host sync."""
        return _build_queue_device(verts_norm, self.tris, self.n,
                                   self.num_chunks, *self.spans)

    def __call__(self, verts_norm: torch.Tensor,
                 check: bool = False) -> torch.Tensor:
        """Deformed vertices -> packed occupancy words [N, N, N//32]."""
        coefs, spans, tile_of, nsub, _, ok = self.build(verts_norm)
        if check and not bool(ok):  # host sync only when asked
            raise RuntimeError(
                "deforming queue overflowed its capacity; rebuild with more "
                "headroom"
            )
        return voxelize_parity_queue_chunks(coefs, tile_of, nsub, self.n,
                                            spans=spans)
