"""Parity voxelization over binned tiles: the CUDA kernel and its plain version.

Port of ``dxrvoxelizer_tpu/ops/voxelize_pallas.py`` (kernel
``_parity_kernel``, launcher ``voxelize_parity_tiles``). Triangles arrive
pre-binned per 32x32-column tile as packed coefficient rows (ops/binning.py);
the output is packed occupancy words [N, N, N//32] int32 (ops/packing.py).
Each row may carry its column span (``spans`` [n_tiles, K, 4] int16: x_lo,
x_hi, y_lo, y_hi in grid columns, the bounding box the binning uses) and
each tile its count of real rows (``counts`` [n_tiles] int32); the kernel
then walks only the real rows and tests each only on the columns
:func:`span_columns` picks (its span widened by one column each side and
clipped to the tile, or the whole tile for a sliver: :func:`sliver_rows`),
the rule it shares with the work-queue kernel (csrc/parity_common.cuh).

- :func:`voxelize_parity_tiles` is the wrapper: a CUDA tensor launches
  ``csrc/parity_voxelize.cu``; a CPU tensor takes the plain version.
- :func:`voxelize_parity_tiles_plain` is the plain torch version: the same
  coverage and cutoff per (column, triangle) on every column of the tile (it
  reads neither spans nor counts), then a per-column histogram of cutoffs
  and a reverse cumulative sum taken mod 2 — a counting reduction
  independent of the kernel's XOR fold. Bit-identity between the two is the
  proof that the span restriction is exact.
- :func:`tile_crossings` is the plain version's per-(column, row) coverage
  and cutoff, and :func:`row_columns` the columns the kernel tests per row:
  the CPU tests hold the one inside the other.
"""

from __future__ import annotations

import torch

from dxrvoxelizer_tpu_torch.ops import _cuda
from dxrvoxelizer_tpu_torch.ops.geom import ParityTris, parity_tri_setup
from dxrvoxelizer_tpu_torch.ops.packing import pack_bits_z

TILE = 32  # columns per tile side
NCOEF = 16  # packed ParityTris coefficients per triangle
SLIVER_K = 2.0 ** -17  # 128 u: the least sin(alpha_min) / R of a narrowed row
# the kernel's layouts (csrc/parity_voxelize.cu): a cluster of blocks per
# tile, blocks per tile with device-memory atomics, the parent's
# every-column kernel
LAYOUTS = {"tile": 0, "split": 1, "column": 2}

# coefficient columns in the packed [T, NCOEF] matrix
_EX0, _EY0, _EO0, _TL0 = 0, 1, 2, 3
_EX1, _EY1, _EO1, _TL1 = 4, 5, 6, 7
_EX2, _EY2, _EO2, _TL2 = 8, 9, 10, 11
_ZX, _ZY, _ZO, _VALID = 12, 13, 14, 15

KERNEL = _cuda.Kernel(
    name="parity_voxelize",
    symbol="parity_kernel",
    source="dxrvoxelizer_tpu_torch/csrc/parity_voxelize.cu",
    replaces="dxrvoxelizer_tpu/ops/voxelize_pallas.py:60",
)


def pack_coeffs(pt: ParityTris) -> torch.Tensor:
    """Stack the 16 per-triangle coefficients into a [T, NCOEF] f32 matrix."""
    return torch.stack(
        [
            pt.ex0, pt.ey0, pt.eo0, pt.tl0,
            pt.ex1, pt.ey1, pt.eo1, pt.tl1,
            pt.ex2, pt.ey2, pt.eo2, pt.tl2,
            pt.zx, pt.zy, pt.zo, pt.valid,
        ],
        dim=1,
    ).to(torch.float32)


def tri_spans(pt: ParityTris, n: int) -> torch.Tensor:
    """Each triangle's column span [T, 4] int16 (x_lo, x_hi, y_lo, y_hi):
    the columns the binning bins it by, [ceil xmin, floor xmax] x
    [ceil ymin, floor ymax], clipped to [-1, n]."""
    box = torch.stack([torch.ceil(pt.xmin), torch.floor(pt.xmax),
                       torch.ceil(pt.ymin), torch.floor(pt.ymax)], dim=1)
    return torch.clamp(box, -1, n).to(torch.int16)


def sliver_rows(coefs: torch.Tensor, spans: torch.Tensor,
                n: int) -> torch.Tensor:
    """[rows] bool: the rows whose columns the kernels take as the whole
    tile, not the span widened by one column.

    A covered column satisfies every edge function as computed in float32:
    the rounding of the evaluation and of the coefficients (ops/geom.py
    ``_edge``) moves each edge line by at most about 11 u R columns (u =
    2^-24; R bounds the vertices' index-space |x| and |y|; the errors scale
    with |edge| R, the edge function with |edge|). Pushing the three edges
    out by rho moves each vertex out by rho / sin(alpha / 2), alpha its
    interior angle, so the covered columns lie within the bounding box grown
    by 16 u R / sin(alpha_min / 2). A row keeps the box widened by one column
    when sin(alpha_min) = area / (product of the two longest edges) >=
    SLIVER_K R (the growth is then under a quarter column), with R =
    max(|x_lo - 1|, |x_hi + 1|, |y_lo - 1|, |y_hi + 1|) + 1; a sliver below
    it (a needle, or a face seen edge-on), and a row whose span the clip to
    [-1, N] may have cut (an end at -1 or N: R unknown), take the whole
    tile. Float64 from the row's float32 edge vectors, each operation
    rounded once, in the kernels' order (csrc/parity_common.cuh)."""
    c = coefs.to(torch.float64)
    ex, ey = c[:, [_EX0, _EX1, _EX2]], c[:, [_EY0, _EY1, _EY2]]
    sq = ex * ex + ey * ey  # squared edge lengths
    longest2 = (sq * sq.roll(1, dims=1)).amax(dim=1)  # (two longest)^2
    area = ex[:, 0] * ey[:, 1] - ey[:, 0] * ex[:, 1]  # cross(e0, e1)
    s = spans.to(torch.int64)
    wide = s + torch.tensor([-1, 1, -1, 1], device=s.device)
    bound = (wide.abs().amax(dim=1) + 1).to(torch.float64) * SLIVER_K
    cut = (s[:, 0] <= -1) | (s[:, 1] >= n) | (s[:, 2] <= -1) | (s[:, 3] >= n)
    return cut | ~(area * area >= bound * bound * longest2)


def span_columns(coefs: torch.Tensor, spans: torch.Tensor, ox: torch.Tensor,
                 oy: torch.Tensor, tile_x: int, tile_y: int,
                 n: int) -> torch.Tensor:
    """The columns a kernel tests for each row of a ``tile_x`` x ``tile_y``
    tile at (``ox``, ``oy``), as it picks them: the span widened by one
    column each side, or the whole tile for a sliver (:func:`sliver_rows`),
    clipped to the tile -> [rows, 4] int64 (x_lo, x_hi, y_lo, y_hi) in
    tile-local columns; empty when x_lo > x_hi or y_lo > y_hi."""
    s = spans.to(torch.int64)
    cols = torch.stack([torch.clamp(s[:, 0] - 1 - ox, min=0),
                        torch.clamp(s[:, 1] + 1 - ox, max=tile_x - 1),
                        torch.clamp(s[:, 2] - 1 - oy, min=0),
                        torch.clamp(s[:, 3] + 1 - oy, max=tile_y - 1)], dim=1)
    whole = torch.tensor([0, tile_x - 1, 0, tile_y - 1], device=s.device)
    return torch.where(sliver_rows(coefs, spans, n)[:, None], whole, cols)


def row_columns(coef_tiles: torch.Tensor, spans: torch.Tensor,
                n: int) -> torch.Tensor:
    """The columns the kernel tests for each binned row -> [n_tiles, K, 4]
    int64 (x_lo, x_hi, y_lo, y_hi) in tile-local columns (x_local = l // 32,
    y_local = l % 32 of column l); :func:`span_columns` per tile."""
    n_tiles, k, _ = coef_tiles.shape
    nt = n // TILE
    t = torch.arange(n_tiles, device=coef_tiles.device).repeat_interleave(k)
    cols = span_columns(coef_tiles.reshape(-1, NCOEF), spans.reshape(-1, 4),
                        (t // nt) * TILE, (t % nt) * TILE, TILE, TILE, n)
    return cols.reshape(n_tiles, k, 4)


def _tile_columns(n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Column-center coordinates [n_tiles, 1024] of every tile's columns;
    tile t = tx*nty + ty, local column l: x = l // 32, y = l % 32."""
    nt = n // TILE
    t = torch.arange(nt * nt, device=device)
    l = torch.arange(TILE * TILE, device=device)
    px = (t // nt)[:, None] * TILE + (l // TILE)[None, :]
    py = (t % nt)[:, None] * TILE + (l % TILE)[None, :]
    return px.to(torch.float32), py.to(torch.float32)


def _tiles_to_grid(tile_words: torch.Tensor, n: int) -> torch.Tensor:
    """[n_tiles, 1024, W] -> packed occupancy words [N, N, W]."""
    nt = n // TILE
    w = tile_words.shape[-1]
    x = tile_words.reshape(nt, nt, TILE, TILE, w)  # [tx, ty, xl, yl, W]
    return x.permute(0, 2, 1, 3, 4).reshape(n, n, w)


def tile_crossings(coef_tiles: torch.Tensor, n: int, rows: slice):
    """The plain version's test of every column of each tile against its
    rows ``rows`` -> (covered [n_tiles, 1024, kc] bool, cutoff m [n_tiles,
    1024, kc] int64 in [0, N]); column l of tile t = tx * (N / 32) + ty is
    (tx * 32 + l // 32, ty * 32 + l % 32)."""
    px, py = _tile_columns(n, coef_tiles.device)
    px, py = px[:, :, None], py[:, :, None]  # [n_tiles, 1024, 1]
    c = coef_tiles[:, None, rows, :]  # [n_tiles, 1, kc, 16]

    def col(r):
        return c[..., r]  # [n_tiles, 1, kc]

    e0 = col(_EX0) * px + col(_EY0) * py + col(_EO0)
    e1 = col(_EX1) * px + col(_EY1) * py + col(_EO1)
    e2 = col(_EX2) * px + col(_EY2) * py + col(_EO2)
    in0 = (e0 > 0) | ((e0 == 0) & (col(_TL0) > 0))
    in1 = (e1 > 0) | ((e1 == 0) & (col(_TL1) > 0))
    in2 = (e2 > 0) | ((e2 == 0) & (col(_TL2) > 0))
    covered = in0 & in1 & in2 & (col(_VALID) > 0)
    z = col(_ZX) * px + col(_ZY) * py + col(_ZO)
    m = torch.clamp(torch.ceil(z), 0.0, float(n)).to(torch.int64)
    return covered, m


def voxelize_parity_tiles_plain(coef_tiles: torch.Tensor, n: int,
                                tri_chunk: int = 256) -> torch.Tensor:
    """Plain torch version of the parity kernel -> words [N, N, N//32]."""
    n_tiles, k, _ = coef_tiles.shape
    # hist[t, l, m]: covered crossings of column l with cutoff m in [0, n]
    hist = torch.zeros((n_tiles, TILE * TILE, n + 1), dtype=torch.int32,
                       device=coef_tiles.device)
    for s in range(0, k, tri_chunk):
        covered, m = tile_crossings(coef_tiles, n, slice(s, s + tri_chunk))
        hist.scatter_add_(2, m, covered.to(torch.int32))
    # voxel k flips once per crossing with cutoff m > k
    above = hist.flip(-1).cumsum(-1).flip(-1)[..., 1:]  # [n_tiles, 1024, n]
    occ = (above & 1).to(torch.bool)
    return _tiles_to_grid(pack_bits_z(occ), n)


def voxelize_parity_tiles(coef_tiles: torch.Tensor, n: int,
                          spans: torch.Tensor | None = None,
                          counts: torch.Tensor | None = None,
                          variant: tuple[str, int, int] | None = None
                          ) -> torch.Tensor:
    """Run the parity kernel over pre-binned tiles -> words [N, N, N//32].

    ``coef_tiles``: [n_tiles, K, NCOEF] f32, zero rows as padding (valid=0).
    ``spans``: [n_tiles, K, 4] int16 column spans or None (every row against
    every column of its tile: the parent's layout). ``counts``: [n_tiles]
    int32, the real rows at the head of each tile (the rows after them must
    be padding), or None (all K rows). ``variant`` = (layout, blocks per
    tile, threads per block), a layout of :data:`LAYOUTS`, picks settings
    other than the main path's (csrc/parity_voxelize.cu; the timing sweep). A CPU
    tensor takes the plain version, which tests every column of every row; a
    CUDA tensor launches the kernel.
    """
    if n % TILE != 0:
        raise ValueError(f"grid size must be a multiple of {TILE}, got {n}")
    n_tiles, k = (n // TILE) ** 2, coef_tiles.shape[1]
    if tuple(coef_tiles.shape) != (n_tiles, k, NCOEF):
        raise ValueError(f"coef_tiles: expected [{n_tiles}, K, {NCOEF}], "
                         f"got {tuple(coef_tiles.shape)}")
    if spans is not None and tuple(spans.shape) != (n_tiles, k, 4):
        raise ValueError(f"spans: expected [{n_tiles}, {k}, 4], "
                         f"got {tuple(spans.shape)}")
    if counts is not None and tuple(counts.shape) != (n_tiles,):
        raise ValueError(f"counts: expected [{n_tiles}], "
                         f"got {tuple(counts.shape)}")
    if variant is not None and (variant[0] not in LAYOUTS
                                or (variant[0] != "column" and spans is None)):
        raise ValueError(f"variant {variant}: a layout of {list(LAYOUTS)}; "
                         "tile and split need spans")
    if coef_tiles.device.type == "cpu":
        return voxelize_parity_tiles_plain(coef_tiles, n)
    _cuda.require(coef_tiles, "coef_tiles", torch.float32)
    if spans is not None:
        _cuda.require(spans, "spans", torch.int16)
    if counts is not None:
        _cuda.require(counts, "counts", torch.int32)
    lib = _cuda.load()
    words = torch.empty((n, n, n // 32), dtype=torch.int32,
                        device=coef_tiles.device)
    args = (coef_tiles.data_ptr(), 0 if spans is None else spans.data_ptr(),
            0 if counts is None else counts.data_ptr(), words.data_ptr(),
            n_tiles, k, n)
    stream = _cuda.stream_ptr(coef_tiles.device)
    if variant is None:
        code = lib.dxv_parity_voxelize(*args, stream)
    else:
        code = lib.dxv_parity_voxelize_variant(
            *args, LAYOUTS[variant[0]], int(variant[1]), int(variant[2]), stream)
    _cuda.check(code, KERNEL.name)
    KERNEL.launches += 1
    return words


def bruteforce_tiles(verts_norm: torch.Tensor, tris: torch.Tensor, n: int,
                     k_chunk: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """Every triangle's row in every tile -> (coef_tiles [n_tiles, K,
    NCOEF], spans [n_tiles, K, 4] int16): the rows zero-padded to a
    multiple of ``k_chunk`` (the padding's spans (-1, -1, -1, -1)); views on
    the CPU, contiguous on a card."""
    pt = parity_tri_setup(verts_norm, tris, n)
    coef, spans = pack_coeffs(pt), tri_spans(pt, n)
    pad = (-coef.shape[0]) % k_chunk
    coef = torch.cat([coef, coef.new_zeros((pad, NCOEF))])
    spans = torch.cat([spans, spans.new_full((pad, 4), -1)])
    n_tiles = (n // TILE) ** 2
    tiles = coef[None].expand(n_tiles, -1, -1)
    tile_spans = spans[None].expand(n_tiles, -1, -1)
    if tiles.device.type != "cpu":  # the plain version takes the views
        tiles, tile_spans = tiles.contiguous(), tile_spans.contiguous()
    return tiles, tile_spans


def voxelize_parity_bruteforce(verts_norm: torch.Tensor, tris: torch.Tensor,
                               n: int, k_chunk: int = 512) -> torch.Tensor:
    """Every tile sees every triangle (no binning) -> words [N, N, N//32].

    Port of ``voxelize_pallas.voxelize_parity_bruteforce``: the triangles'
    rows, zero-padded to a multiple of ``k_chunk``, repeated for every tile
    with their spans (:func:`bruteforce_tiles`) and run through
    :func:`voxelize_parity_tiles` (the kernel on a GPU, which tests each row
    only on its span's columns; its plain version on the CPU). Correct at
    any size; the binned path is the fast one."""
    if n % TILE != 0:
        raise ValueError(f"grid size must be a multiple of {TILE}, got {n}")
    if tris.shape[0] == 0:
        return torch.zeros((n, n, n // 32), dtype=torch.int32,
                           device=verts_norm.device)
    tiles, spans = bruteforce_tiles(verts_norm, tris, n, k_chunk)
    return voxelize_parity_tiles(tiles, n, spans=spans)
