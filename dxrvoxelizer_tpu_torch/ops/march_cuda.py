"""Fused shear-warp march: the CUDA kernel and its plain version.

Port of ``dxrvoxelizer_tpu/ops/march_pallas.py`` (kernel ``_march_kernel``,
launcher ``march_pallas``). Sub-slab s of KS = K*ss z-mixes the (density,
light) source slabs with weight ``wts[s]``, warps them to the M x M
intermediate, and composites front to back with the shader's absorption
rules (PSRayCast.hlsl:134-179).

The warp is given as each sub-slab's scale and offset (x_in = scale *
(i + 0.5) + offset per axis, ops/warp.py) instead of the dense [KS, M, N]
interpolation matrices of the TPU kernel: the CUDA kernel rebuilds the two
non-zero weights per pixel, the plain version builds the matrices. The
kernel stages each 8x8 pixel tile's texel box of a few source slabs at a
time in shared memory; :func:`march_ring` sizes that ring on the host.

- :func:`march` is the wrapper: a CUDA tensor launches ``csrc/march.cu``; a
  CPU tensor takes the plain version.
- :func:`march_plain` is the XLA path of the JAX package's
  ``_shearwarp_core``: z-lerp, ``warp2d`` through ``torch.matmul``, and the
  per-slab compositing loop.
"""

from __future__ import annotations

import numpy as np
import torch

from dxrvoxelizer_tpu_torch.ops import _cuda
from dxrvoxelizer_tpu_torch.ops.raymarch_ref import ABSORPTION, ZERO_THRESHOLD
from dxrvoxelizer_tpu_torch.ops.warp import interp_matrix, scale_offset_coords, warp2d

KERNEL = _cuda.Kernel(
    name="march",
    symbol="march_kernel",
    source="dxrvoxelizer_tpu_torch/csrc/march.cu",
    replaces="dxrvoxelizer_tpu/ops/march_pallas.py:44",
)


TILE = 8  # pixels per side of a block's tile (csrc/march.cu kTile)
CHUNK_SLABS = 4  # source slabs per chunk of the kernel's shared-memory ring
# shared memory per block that leaves room for two blocks per SM (of 228 KB)
RING_BUDGET = 110 * 1024


def chunk_starts(kn: int, ss: int, cz: int = CHUNK_SLABS) -> list[int]:
    """First sub-slab of each chunk: the sub-slabs whose first z-mix slab
    (:func:`zmix_slabs` ``i0``) lies in source slabs [c*cz, (c+1)*cz)
    (csrc/march.cu sub_begin)."""
    ks = kn * ss
    return [0 if z == 0 else min(ks, ss * z + ss // 2)
            for z in range(0, kn, cz)]


def _tile_boxes(scale_x, off_x, scale_y, off_y, m: int):
    """Per sub-slab and TILE x TILE tile, the texel box its taps read ->
    (lo, hi), [2 axes (x, y), K*ss, tiles] each, not yet clamped to the
    grid (integral float32).

    Per axis the box runs from the floor of the tile's first pixel's
    coordinate to the floor of its last pixel's plus one, with the kernel's
    float32 arithmetic."""
    first = np.arange(0, m, TILE)
    ends = np.concatenate([first, np.minimum(first + TILE, m) - 1])
    so = np.stack([np.asarray(a, np.float32)
                   for a in (scale_x, scale_y, off_x, off_y)])[..., None]
    # floor(scale * (p + 0.5) + off), as the kernel rounds it;
    # [axis, sub-slab, first/last pixel, tile]
    f = np.floor(so[:2] * (ends.astype(np.float32) + np.float32(0.5))
                 + so[2:]).reshape(2, -1, 2, len(first))
    a, b = f[:, :, 0], f[:, :, 1]
    return np.minimum(a, b), np.maximum(a, b) + 1


def _chunk_box(boxes, starts: list[int], n: int) -> tuple[int, int]:
    """The largest union of :func:`_tile_boxes` over a chunk's sub-slabs
    (chunks begin at ``starts``), clamped to the grid -> (rows, columns
    from a multiple of 4). Clamping commutes with the union."""
    lo = np.minimum.reduceat(boxes[0], starts, axis=1).clip(0, n - 1)
    hi = np.maximum.reduceat(boxes[1], starts, axis=1).clip(0, n - 1)
    rows = int((hi[0] - lo[0] + 1).max(initial=0))
    y0 = lo[1] // 4 * 4
    cols = int(((hi[1] + 1 - y0 + 3) // 4 * 4).max(initial=0))
    return rows, cols


def march_footprint(scale_x, off_x, scale_y, off_y, m: int, n: int, ss: int,
                    cz: int = CHUNK_SLABS) -> tuple[int, int]:
    """The largest texel box that one TILE x TILE tile's taps read in any
    chunk of ``cz`` source slabs -> (rows, columns), the columns from a
    multiple of 4 and rounded up to one (16-byte TMA rows); a chunk's box is
    the union of its sub-slabs' boxes (:func:`_tile_boxes`).
    ``scale_*``/``off_*`` [K*ss] on the host (numpy or CPU tensors).
    """
    return _chunk_box(_tile_boxes(scale_x, off_x, scale_y, off_y, m),
                      chunk_starts(len(scale_x) // ss, ss, cz), n)


def march_ring(scale_x, off_x, scale_y, off_y, m: int, n: int,
               ss: int) -> tuple[int, int, int]:
    """The kernel's shared-memory ring -> (source slabs per chunk, box rows,
    box columns): CHUNK_SLABS slabs, or fewer where two stages of the
    largest box (density and light, one slab more when z-mixing) and the
    per-sub-slab tables would leave no room for two blocks per SM. The
    per-sub-slab boxes are computed once; each chunk size only unites them."""
    ks = len(scale_x)
    boxes = _tile_boxes(scale_x, off_x, scale_y, off_y, m)
    for cz in range(CHUNK_SLABS, 0, -1):
        rows, cols = _chunk_box(boxes, chunk_starts(ks // ss, ss, cz), n)
        ring = 2 * 2 * (cz + (ss > 1)) * rows * cols * 4
        if ring + ks * 24 + 4096 <= RING_BUDGET:
            break
    return cz, rows, cols


def zmix_slabs(kn: int, ss: int, device) -> tuple[torch.Tensor, torch.Tensor,
                                                  torch.Tensor]:
    """Sub-slab z-mix: source slabs (i0, i1) and the weight of i1, [KS] each.

    Sample s sits at ``pos = (s + 0.5)/ss - 0.5`` slabs, LINEAR_CLAMP at the
    volume's ends.
    """
    ks = kn * ss
    pos = (torch.arange(ks, dtype=torch.float32, device=device) + 0.5) / ss - 0.5
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, kn - 1)
    i1 = torch.clamp(i0 + 1, 0, kn - 1)
    w1 = torch.clamp(pos - i0.to(torch.float32), 0.0, 1.0)
    return i0, i1, w1


def march_plain(slabs, wts, front, scale_x, off_x, scale_y, off_y, delta,
                ss: int):
    """Plain torch march -> (transmit [M, M], scatter [M, M])."""
    if slabs.is_cuda:
        assert not torch.backends.cuda.matmul.allow_tf32, "the march is FP32"
    _two, kn, n, _ = slabs.shape
    m = delta.shape[0]
    if ss > 1:
        i0, i1, _ = zmix_slabs(kn, ss, slabs.device)
        slabs = (
            slabs[:, i0] * (1.0 - wts)[None, :, None, None]
            + slabs[:, i1] * wts[None, :, None, None]
        )  # [2, KS, X, Y]
    wx = interp_matrix(scale_offset_coords(m, scale_x, off_x), n)  # [KS, M, N]
    wy = interp_matrix(scale_offset_coords(m, scale_y, off_y), n)
    dens_w = warp2d(slabs[0], wx, wy)  # [KS, M, M]
    light_w = warp2d(slabs[1], wx, wy)

    transmit = torch.ones((m, m), dtype=torch.float32, device=slabs.device)
    scatter = torch.zeros((m, m), dtype=torch.float32, device=slabs.device)
    zero = torch.zeros((), dtype=torch.float32, device=slabs.device)
    one = torch.ones((), dtype=torch.float32, device=slabs.device)
    for s in range(kn * ss):
        g_s = torch.clamp(dens_w[s] * 8.0, max=16.0)
        occupied = (g_s > ZERO_THRESHOLD) & (front[s] > 0)
        sigma = g_s * delta
        att = torch.where(
            occupied, torch.clamp(1.0 - sigma * ABSORPTION, 0.0, 1.0), one
        )
        new_transmit = transmit * att
        contributes = occupied & (new_transmit >= ZERO_THRESHOLD)
        scatter = scatter + torch.where(
            contributes, light_w[s] * new_transmit * sigma, zero
        )
        # shader break: once transmit dies it stays at the dying value
        transmit = torch.where(transmit >= ZERO_THRESHOLD, new_transmit, transmit)
    return transmit, scatter


def march(slabs, wts, front, scale_x, off_x, scale_y, off_y, delta, ss: int,
          *, ring: tuple[int, int, int]):
    """Fused march -> (transmit [M, M], scatter [M, M]).

    ``slabs`` [2, K, N, N] f32 (density, light; far axis first; N a
    multiple of 4 for the kernel); ``wts``, ``front``, ``scale_*``,
    ``off_*`` [K*ss] f32; ``delta`` [M, M] f32 per-pixel step lengths.
    ``ring``: the kernel's shared-memory ring, (source slabs per chunk, box
    rows, box columns), sized on the host by :func:`march_ring` (the frame
    passes ``MarchInputs.ring``). A CPU tensor takes the plain version.
    """
    if slabs.device.type == "cpu":
        return march_plain(slabs, wts, front, scale_x, off_x, scale_y, off_y,
                           delta, ss)
    kn, n = slabs.shape[1], slabs.shape[2]
    ks = kn * ss
    m = delta.shape[0]
    _cuda.require(slabs, "slabs", torch.float32, (2, kn, n, n))
    if n % 4 or slabs.data_ptr() % 16:
        raise ValueError(f"slabs: the kernel copies 16-byte rows: N = {n} "
                         "must be a multiple of 4 and the data 16-byte aligned")
    for name, t in (("wts", wts), ("front", front), ("scale_x", scale_x),
                    ("off_x", off_x), ("scale_y", scale_y), ("off_y", off_y)):
        _cuda.require(t, name, torch.float32, (ks,))
    _cuda.require(delta, "delta", torch.float32, (m, m))
    cz, fx, fy4 = ring
    lib = _cuda.load()
    transmit = torch.empty((m, m), dtype=torch.float32, device=slabs.device)
    scatter = torch.empty((m, m), dtype=torch.float32, device=slabs.device)
    code = lib.dxv_march(
        slabs.data_ptr(), wts.data_ptr(), front.data_ptr(),
        scale_x.data_ptr(), off_x.data_ptr(), scale_y.data_ptr(),
        off_y.data_ptr(), delta.data_ptr(), transmit.data_ptr(),
        scatter.data_ptr(), kn, n, m, ss, cz, fx, fy4,
        _cuda.stream_ptr(slabs.device),
    )
    _cuda.check(code, KERNEL.name)
    KERNEL.launches += 1
    return transmit, scatter
