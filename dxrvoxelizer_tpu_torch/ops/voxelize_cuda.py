"""Parity voxelization over binned tiles: the CUDA kernel and its plain version.

Port of ``dxrvoxelizer_tpu/ops/voxelize_pallas.py`` (kernel
``_parity_kernel``, launcher ``voxelize_parity_tiles``). Triangles arrive
pre-binned per 32x32-column tile as packed coefficient rows (ops/binning.py);
the output is packed occupancy words [N, N, N//32] int32 (ops/packing.py).

- :func:`voxelize_parity_tiles` is the wrapper: a CUDA tensor launches
  ``csrc/parity_voxelize.cu``; a CPU tensor takes the plain version.
- :func:`voxelize_parity_tiles_plain` is the plain torch version: the same
  coverage and cutoff per (column, triangle), then a per-column histogram of
  cutoffs and a reverse cumulative sum taken mod 2 — a counting reduction
  independent of the kernel's XOR fold.
"""

from __future__ import annotations

import torch

from dxrvoxelizer_tpu_torch.ops import _cuda
from dxrvoxelizer_tpu_torch.ops.geom import ParityTris, parity_tri_setup
from dxrvoxelizer_tpu_torch.ops.packing import pack_bits_z

TILE = 32  # columns per tile side
NCOEF = 16  # packed ParityTris coefficients per triangle
K_CHUNK = 128  # triangles per CUDA block (tiles split across blocks)

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


def voxelize_parity_tiles_plain(coef_tiles: torch.Tensor, n: int,
                                tri_chunk: int = 256) -> torch.Tensor:
    """Plain torch version of the parity kernel -> words [N, N, N//32]."""
    n_tiles, k, _ = coef_tiles.shape
    px, py = _tile_columns(n, coef_tiles.device)
    px, py = px[:, :, None], py[:, :, None]  # [n_tiles, 1024, 1]
    # hist[t, l, m]: covered crossings of column l with cutoff m in [0, n]
    hist = torch.zeros((n_tiles, TILE * TILE, n + 1), dtype=torch.int32,
                       device=coef_tiles.device)
    for s in range(0, k, tri_chunk):
        c = coef_tiles[:, None, s:s + tri_chunk, :]  # [n_tiles, 1, kc, 16]

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
        hist.scatter_add_(2, m, covered.to(torch.int32))
    # voxel k flips once per crossing with cutoff m > k
    above = hist.flip(-1).cumsum(-1).flip(-1)[..., 1:]  # [n_tiles, 1024, n]
    occ = (above & 1).to(torch.bool)
    return _tiles_to_grid(pack_bits_z(occ), n)


def voxelize_parity_tiles(coef_tiles: torch.Tensor, n: int) -> torch.Tensor:
    """Run the parity kernel over pre-binned tiles -> words [N, N, N//32].

    ``coef_tiles``: [n_tiles, K, NCOEF] f32, zero rows as padding (valid=0).
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if n % TILE != 0:
        raise ValueError(f"grid size must be a multiple of {TILE}, got {n}")
    n_tiles, k = (n // TILE) ** 2, coef_tiles.shape[1]
    if tuple(coef_tiles.shape) != (n_tiles, k, NCOEF):
        raise ValueError(f"coef_tiles: expected [{n_tiles}, K, {NCOEF}], "
                         f"got {tuple(coef_tiles.shape)}")
    if coef_tiles.device.type == "cpu":
        return voxelize_parity_tiles_plain(coef_tiles, n)
    _cuda.require(coef_tiles, "coef_tiles", torch.float32)
    lib = _cuda.load()
    words = torch.empty((n, n, n // 32), dtype=torch.int32,
                        device=coef_tiles.device)
    code = lib.dxv_parity_voxelize(
        coef_tiles.data_ptr(), words.data_ptr(), n_tiles, k, n, K_CHUNK,
        _cuda.stream_ptr(coef_tiles.device),
    )
    _cuda.check(code, KERNEL.name)
    KERNEL.launches += 1
    return words


def voxelize_parity_bruteforce(verts_norm: torch.Tensor, tris: torch.Tensor,
                               n: int, k_chunk: int = 512) -> torch.Tensor:
    """Every tile sees every triangle (no binning) -> words [N, N, N//32].

    Port of ``voxelize_pallas.voxelize_parity_bruteforce``: the triangles'
    rows, zero-padded to a multiple of ``k_chunk``, repeated for every tile
    and run through :func:`voxelize_parity_tiles` (the kernel on a GPU, its
    plain version on the CPU). Correct at any size; the binned path is the
    fast one."""
    if n % TILE != 0:
        raise ValueError(f"grid size must be a multiple of {TILE}, got {n}")
    if tris.shape[0] == 0:
        return torch.zeros((n, n, n // 32), dtype=torch.int32,
                           device=verts_norm.device)
    coef = pack_coeffs(parity_tri_setup(verts_norm, tris, n))
    pad = (-coef.shape[0]) % k_chunk
    coef = torch.cat([coef, coef.new_zeros((pad, NCOEF))])
    tiles = coef[None].expand((n // TILE) ** 2, -1, -1)
    if tiles.device.type != "cpu":  # the plain version takes the view
        tiles = tiles.contiguous()
    return voxelize_parity_tiles(tiles, n)
