"""Parity voxelization from a flat chunk queue: the CUDA kernel and its plain
version.

Port of the kernel of ``dxrvoxelizer_tpu/ops/voxelize_queue.py``
(``_queue_kernel`` / ``_queue_chunk``, launched by ``_queue_run_group``).
The queue (ops/voxelize_queue.py::build_queue) lays each 16x8-column tile's
triangles out as chunks of ``k_chunk`` packed coefficient rows; chunk c
belongs to tile ``chunk_tile[c]`` and holds ``chunk_nsub[c] * SUB`` live
rows (the rest are zero rows, valid = 0). Tile t = tx * (N / TILE_Y) + ty;
its lane l covers column (tx * TILE_X + l // TILE_Y, ty * TILE_Y + l % TILE_Y).
The output is packed occupancy words [N, N, N//32] int32 (ops/packing.py).
Each row may carry its column span (``spans`` [rows, 4] int16: x_lo, x_hi,
y_lo, y_hi in grid columns, the bounding box the binning uses); the kernel
tests only the span's columns widened by one each side and clipped to the
tile, or the whole tile for a sliver (:func:`row_columns`; the rule it
shares with kernel 2.1, csrc/parity_common.cuh).

- :func:`voxelize_parity_queue_chunks` is the wrapper: a CUDA tensor
  launches ``csrc/parity_queue.cu``; a CPU tensor takes the plain version.
  With ``tiles`` it computes only the tile group ``[tile_lo, tile_lo +
  tiles)`` (a rank's share of a sharded voxelize, parallel/shard.py) as
  ``[tiles, N//32, 128]`` words in the JAX package's tile layout
  (``_queue_run_group``'s output; :func:`_tiles_to_grid` assembles them).
- :func:`voxelize_parity_queue_chunks_plain` is the plain torch version: the
  same coverage and cutoff per (column, live row) on all 128 columns of the
  tile (it never reads a span), then a per-column histogram of cutoffs and a
  reverse cumulative sum taken mod 2 — a counting reduction independent of
  the kernel's single-bit XOR and suffix parity. Bit-identity between the two
  is the proof that the span restriction is exact.
- :func:`queue_crossings` is the plain version's per-(row, column) coverage
  and cutoff, and :func:`row_columns` the columns the kernel tests per row:
  the CPU tests hold the one inside the other.
"""

from __future__ import annotations

import torch

from dxrvoxelizer_tpu_torch.ops import _cuda
from dxrvoxelizer_tpu_torch.ops.packing import pack_bits_z
from dxrvoxelizer_tpu_torch.ops.voxelize_cuda import (  # noqa: F401 (re-exported)
    _EO0, _EO1, _EO2, _EX0, _EX1, _EX2, _EY0, _EY1, _EY2,
    _TL0, _TL1, _TL2, _VALID, _ZO, _ZX, _ZY, NCOEF, sliver_rows, span_columns,
)

TILE_X = 16  # tile extent in grid-x columns
TILE_Y = 8  # tile extent in grid-y columns (16*8 = 128 columns per tile)
LANES = TILE_X * TILE_Y
SUB = 8  # rows per sub-block: chunk_nsub counts these
K_CHUNK = 64  # coefficient rows per queue chunk
PLAIN_BATCH = 512  # chunks per step of the plain version (bounds its memory)
# histogram entries per tile group of the plain version (bounds its memory:
# one histogram of every tile would take 4.3 GB at 1024^3, its flips and
# sums as much again)
PLAIN_HIST = 1 << 26

KERNEL = _cuda.Kernel(
    name="parity_queue",
    symbol="queue_kernel",
    source="dxrvoxelizer_tpu_torch/csrc/parity_queue.cu",
    replaces="dxrvoxelizer_tpu/ops/voxelize_queue.py:68",
)


def _tiles_to_grid(out: torch.Tensor, n: int) -> torch.Tensor:
    """Occupancy tiles [n_tiles, W, 128] -> packed occupancy [N, N, W]."""
    w_words = n // 32
    ntx, nty = n // TILE_X, n // TILE_Y
    x = out.reshape(ntx, nty, w_words, TILE_X, TILE_Y)
    x = x.permute(0, 3, 1, 4, 2)  # [ntx, xl, nty, yl, W]
    return x.reshape(n, n, w_words)


def _check_queue(coefs, chunk_tile, chunk_nsub, n: int, tile_lo: int = 0,
                 tiles: int | None = None) -> tuple[int, int]:
    """Validate a queue (and a tile group) -> (num_chunks, k_chunk rows per
    chunk)."""
    if n % 32 != 0:
        raise ValueError(f"grid size must be a multiple of 32, got {n}")
    n_tiles = (n // TILE_X) * (n // TILE_Y)
    if tiles is not None and not (0 <= tile_lo and 0 <= tiles
                                  and tile_lo + tiles <= n_tiles):
        raise ValueError(f"tile group [{tile_lo}, {tile_lo} + {tiles}) "
                         f"outside the {n_tiles} tiles")
    num_chunks = chunk_tile.shape[0]
    k_chunk = coefs.shape[0] // max(num_chunks, 1)
    if (coefs.ndim != 2 or coefs.shape[1] != NCOEF or k_chunk % SUB != 0
            or coefs.shape[0] != num_chunks * k_chunk):
        raise ValueError(f"coefs: expected [num_chunks * k_chunk, {NCOEF}] "
                         f"with k_chunk a multiple of {SUB} for {num_chunks} "
                         f"chunks, got {tuple(coefs.shape)}")
    if tuple(chunk_nsub.shape) != (num_chunks,):
        raise ValueError(f"chunk_nsub: expected [{num_chunks}], "
                         f"got {tuple(chunk_nsub.shape)}")
    return num_chunks, k_chunk


def queue_crossings(coefs: torch.Tensor, chunk_tile: torch.Tensor,
                    chunk_nsub: torch.Tensor, n: int,
                    chunks: slice | torch.Tensor):
    """The plain version's test of every column of each chunk's tile against
    every live row, for the chunks ``chunks`` (a slice or an index tensor)
    -> (covered [b, 128, k] bool,
    cutoff m [b, 128, k] int64 in [0, N]); lane l of tile t is column
    (tx * TILE_X + l // TILE_Y, ty * TILE_Y + l % TILE_Y)."""
    num_chunks, k_chunk = _check_queue(coefs, chunk_tile, chunk_nsub, n)
    dev = coefs.device
    nty = n // TILE_Y
    lane = torch.arange(LANES, device=dev)
    slot = torch.arange(k_chunk, device=dev)
    c = coefs.reshape(num_chunks, k_chunk, NCOEF)[chunks, None, :, :]  # [b,1,k,16]
    tile = chunk_tile[chunks].to(torch.int64)
    live = slot[None, :] < (chunk_nsub[chunks, None] * SUB)  # [b, k]
    px = ((tile // nty)[:, None] * TILE_X + lane // TILE_Y)[:, :, None]
    py = ((tile % nty)[:, None] * TILE_Y + lane % TILE_Y)[:, :, None]
    px, py = px.to(torch.float32), py.to(torch.float32)  # [b, 128, 1]

    def col(r):
        return c[..., r]  # [b, 1, k]

    e0 = col(_EX0) * px + col(_EY0) * py + col(_EO0)
    e1 = col(_EX1) * px + col(_EY1) * py + col(_EO1)
    e2 = col(_EX2) * px + col(_EY2) * py + col(_EO2)
    in0 = (e0 > 0) | ((e0 == 0) & (col(_TL0) > 0))
    in1 = (e1 > 0) | ((e1 == 0) & (col(_TL1) > 0))
    in2 = (e2 > 0) | ((e2 == 0) & (col(_TL2) > 0))
    covered = in0 & in1 & in2 & (col(_VALID) > 0) & live[:, None, :]
    z = col(_ZX) * px + col(_ZY) * py + col(_ZO)
    m = torch.clamp(torch.ceil(z), 0.0, float(n)).to(torch.int64)
    return covered, m


def row_columns(coefs: torch.Tensor, spans: torch.Tensor,
                chunk_tile: torch.Tensor, n: int) -> torch.Tensor:
    """The columns the kernel tests for each row, as it picks them
    (:func:`voxelize_cuda.span_columns` in the row's tile) -> [rows, 4]
    int64 (x_lo, x_hi, y_lo, y_hi) in tile-local columns."""
    nty = n // TILE_Y
    k_chunk = spans.shape[0] // max(chunk_tile.shape[0], 1)
    tile = chunk_tile.to(torch.int64).repeat_interleave(k_chunk)
    return span_columns(coefs, spans, (tile // nty) * TILE_X,
                        (tile % nty) * TILE_Y, TILE_X, TILE_Y, n)


def voxelize_parity_queue_chunks_plain(coefs: torch.Tensor,
                                       chunk_tile: torch.Tensor,
                                       chunk_nsub: torch.Tensor,
                                       n: int, tile_lo: int = 0,
                                       tiles: int | None = None
                                       ) -> torch.Tensor:
    """Plain torch version of the queue kernel -> words [N, N, N//32], or
    with ``tiles`` the group's [tiles, N//32, 128] (chunks of other tiles
    are left out). The tiles are taken in groups of at most
    ``PLAIN_HIST // (128 * (N + 1))``, each with a histogram of its own."""
    _check_queue(coefs, chunk_tile, chunk_nsub, n, tile_lo, tiles)
    n_out = (n // TILE_X) * (n // TILE_Y) if tiles is None else tiles
    step = max(1, PLAIN_HIST // (LANES * (n + 1)))
    words = torch.cat([
        _plain_group(coefs, chunk_tile, chunk_nsub, n, lo,
                     min(step, tile_lo + n_out - lo))
        for lo in range(tile_lo, tile_lo + n_out, step)
    ]) if n_out else torch.zeros((0, n // 32, LANES), dtype=torch.int32,
                                 device=coefs.device)
    return words if tiles is not None else _tiles_to_grid(words, n)


def _plain_group(coefs, chunk_tile, chunk_nsub, n: int, tile_lo: int,
                 tiles: int) -> torch.Tensor:
    """The plain version on the tiles [tile_lo, tile_lo + tiles) ->
    [tiles, N//32, 128] words, from the chunks of those tiles only."""
    dev = coefs.device
    lane = torch.arange(LANES, device=dev)
    rel_all = chunk_tile.to(torch.int64) - tile_lo
    mine = torch.nonzero((rel_all >= 0) & (rel_all < tiles)).reshape(-1)
    # hist[t, l, m]: covered crossings of column l of tile tile_lo + t with
    # cutoff m
    hist = torch.zeros(tiles * LANES * (n + 1), dtype=torch.int32, device=dev)
    for s in range(0, mine.shape[0], PLAIN_BATCH):
        b = mine[s:s + PLAIN_BATCH]
        covered, m = queue_crossings(coefs, chunk_tile, chunk_nsub, n, b)
        idx = (rel_all[b][:, None, None] * LANES + lane[None, :, None]) * (n + 1) + m
        hist.scatter_add_(0, idx.reshape(-1), covered.to(torch.int32).reshape(-1))
    # voxel k flips once per crossing with cutoff m > k
    hist = hist.view(tiles, LANES, n + 1)
    above = hist.flip(-1).cumsum(-1, dtype=torch.int32).flip(-1)[..., 1:]
    return pack_bits_z((above & 1).to(torch.bool)).transpose(1, 2).contiguous()


def voxelize_parity_queue_chunks(coefs: torch.Tensor, chunk_tile: torch.Tensor,
                                 chunk_nsub: torch.Tensor, n: int,
                                 spans: torch.Tensor | None = None,
                                 variant: tuple[bool, int] | None = None,
                                 tile_lo: int = 0, tiles: int | None = None
                                 ) -> torch.Tensor:
    """Run the queue kernel -> packed occupancy words [N, N, N//32], or with
    ``tiles`` the tile group ``[tile_lo, tile_lo + tiles)``'s words
    [tiles, N//32, 128] (tile layout, lane = x_local * TILE_Y + y_local).

    ``coefs`` [num_chunks * k_chunk, NCOEF] f32 (``k_chunk`` rows per chunk,
    a multiple of 8; the queue build uses K_CHUNK); ``chunk_tile`` and
    ``chunk_nsub`` [num_chunks] int32, ``chunk_tile`` non-decreasing and a
    tile's chunks with no live row after its others (the queue build's
    layout: a tile's chunks back to back, padding chunks last); ``spans``
    [num_chunks * k_chunk, 4] int16 column spans or None (every row spans
    its tile). ``variant`` = (one block per tile run, else one per chunk;
    threads) picks a layout and block size of the kernel other than the
    main path's (csrc/parity_queue.cu; the timing sweep; not with
    ``tiles``). A CPU tensor takes the plain version, which tests every
    column; a CUDA tensor launches the kernel.
    """
    num_chunks, k_chunk = _check_queue(coefs, chunk_tile, chunk_nsub, n,
                                       tile_lo, tiles)
    if variant is not None and tiles is not None:
        raise ValueError("the timing sweep's variants cover the whole grid")
    if spans is not None and tuple(spans.shape) != (coefs.shape[0], 4):
        raise ValueError(f"spans: expected [{coefs.shape[0]}, 4], "
                         f"got {tuple(spans.shape)}")
    if coefs.device.type == "cpu":
        return voxelize_parity_queue_chunks_plain(coefs, chunk_tile,
                                                  chunk_nsub, n, tile_lo, tiles)
    _cuda.require(coefs, "coefs", torch.float32)
    _cuda.require(chunk_tile, "chunk_tile", torch.int32)
    _cuda.require(chunk_nsub, "chunk_nsub", torch.int32)
    if spans is not None:
        _cuda.require(spans, "spans", torch.int16)
    lib = _cuda.load()
    sp = 0 if spans is None else spans.data_ptr()
    if tiles is not None:
        group = torch.empty((tiles, n // 32, LANES), dtype=torch.int32,
                            device=coefs.device)
        code = lib.dxv_parity_queue_group(
            coefs.data_ptr(), sp, chunk_tile.data_ptr(), chunk_nsub.data_ptr(),
            group.data_ptr(), tile_lo, tiles, num_chunks, n, k_chunk,
            _cuda.stream_ptr(coefs.device))
        _cuda.check(code, KERNEL.name)
        KERNEL.launches += 1
        return group
    words = torch.empty((n, n, n // 32), dtype=torch.int32, device=coefs.device)
    args = (coefs.data_ptr(), sp, chunk_tile.data_ptr(), chunk_nsub.data_ptr(),
            words.data_ptr(), num_chunks, n, k_chunk)
    if variant is None:
        code = lib.dxv_parity_queue(*args, _cuda.stream_ptr(coefs.device))
    else:
        code = lib.dxv_parity_queue_variant(
            *args, int(variant[0]), int(variant[1]),
            _cuda.stream_ptr(coefs.device))
    _cuda.check(code, KERNEL.name)
    KERNEL.launches += 1
    return words
