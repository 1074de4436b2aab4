"""Trusted reference (oracle) voxelizers in plain torch.

Port of ``dxrvoxelizer_tpu/ops/voxelize_ref.py``, two inside rules:

- :func:`voxelize_raystab_ref` — the reference's exact algorithm: one radial
  ray per voxel from the voxel centre outward, closest hit (Moller-Trumbore),
  voxel inside iff the interpolated normal faces away: ``dot(n, dir) > 0.12``
  (DXRVoxelizer.hlsl:44-53, 132-140); also the ``float4(Normal, 1.0)`` grid
  (DXRVoxelizer.hlsl:83-84); the bit-exact ground truth of the gen-1 query
  (ops/raystab_fast.py). :func:`voxelize_raystab_radial_ref` picks the
  winner with the radial form instead: the bit-exact ground truth of the
  gen-6 query.
- :func:`voxelize_parity_ref` — axis-aligned column rays with
  intersection-parity counting. It *counts* crossings per voxel; the CUDA
  kernel (ops/voxelize_cuda.py) folds XOR masks and its plain version
  histograms cutoffs — independent reductions over identical tests.
"""

from __future__ import annotations

import torch

from dxrvoxelizer_tpu_torch.ops import intersect
from dxrvoxelizer_tpu_torch.ops.geom import column_crossing, parity_tri_setup
from dxrvoxelizer_tpu_torch.ops.raystab_fast import INSIDE_THRESHOLD, voxel_rays


def voxelize_raystab_ref(verts_norm: torch.Tensor, normals: torch.Tensor,
                         tris: torch.Tensor, n: int = 64,
                         threshold: float = INSIDE_THRESHOLD,
                         ray_chunk: int = 4096, tri_chunk: int = 2048,
                         rule: str = "backface"):
    """Reference-rule solid voxelization (Moller-Trumbore) ->
    ``(occupancy [n,n,n] bool, rgba [n,n,n,4] f32)``, rgba the unquantized
    ``float4(Normal, 1.0)`` write (zeros outside). ``rule`` "hit" marks every
    voxel whose ray hits anything (the parity-mode normal-channel source)."""
    pos, dirs = voxel_rays(n, verts_norm.device)
    v0, e1, e2 = intersect.triangle_soup(verts_norm, tris)
    n0, n1, n2 = (normals[tris[:, k]] for k in range(3))
    occ, rgba = [], []
    for s in range(0, pos.shape[0], ray_chunk):
        o, d = pos[s:s + ray_chunk], dirs[s:s + ray_chunk]
        t, u, v, idx = intersect.closest_hit(o, d, v0, e1, e2, tri_chunk)
        idx = idx.to(torch.int64)
        inside, nx, ny, nz = intersect.mt_finalize(
            d, n0[idx], n1[idx], n2[idx], u, v, torch.isfinite(t), threshold, rule)
        occ.append(inside)
        rgba.append(intersect.rgba_channels(inside, nx, ny, nz))
    return torch.cat(occ).reshape(n, n, n), torch.cat(rgba).reshape(n, n, n, 4)


def voxelize_raystab_radial_ref(verts_norm: torch.Tensor, normals: torch.Tensor,
                                tris: torch.Tensor, n: int = 64,
                                threshold: float = INSIDE_THRESHOLD,
                                ray_chunk: int = 4096, tri_chunk: int = 2048,
                                rule: str = "backface",
                                normal_impl: str = "radial"):
    """Reference-rule voxelization via the radial-form intersection: the
    same rays and inside rule as :func:`voxelize_raystab_ref`, the winner
    picked by ``intersect.radial_hit`` (origin = s0 * dir,
    DXRVoxelizer.hlsl:44-53).

    ``normal_impl``: "radial" (the gen-6 query's contract, bit for bit):
    barycentrics from the radial signed volumes, ``nrm = normalize((w0 n0 +
    w1 n1 + w2 n2) / den)`` (``intersect.radial_finalize``); "mt": the
    Moller-Trumbore (u, v) interpolation of the winner, as the MT oracle.
    """
    pos, dirs = voxel_rays(n, verts_norm.device)
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    s0_all = intersect.sqrt_rn((x * x + y * y) + z * z)
    g0, g1, g2, c = intersect.radial_setup(verts_norm, tris)
    v0, e1, e2 = intersect.triangle_soup(verts_norm, tris)
    n0, n1, n2 = (normals[tris[:, k]] for k in range(3))
    t_count = tris.shape[0]
    occ, rgba = [], []
    for s in range(0, pos.shape[0], ray_chunk):
        o, d, s0 = pos[s:s + ray_chunk], dirs[s:s + ray_chunk], s0_all[s:s + ray_chunk]
        t, idx = intersect.radial_closest_hit(d, s0, g0, g1, g2, c, tri_chunk)
        hit = torch.isfinite(t) & (idx < t_count)
        idx = torch.where(hit, idx, torch.zeros_like(idx)).to(torch.int64)
        if normal_impl == "radial":
            gg = [g[idx, k] for g in (g0, g1, g2) for k in range(3)]
            nv = [nn[idx, k] for nn in (n0, n1, n2) for k in range(3)]
            inside, nx, ny, nz = intersect.radial_finalize(
                d[:, 0], d[:, 1], d[:, 2], gg, nv, hit, threshold, rule)
        else:
            _, u, v, _ = intersect.mt_hit(o, d, v0[idx], e1[idx], e2[idx])
            inside, nx, ny, nz = intersect.mt_finalize(
                d, n0[idx], n1[idx], n2[idx], u, v, hit, threshold, rule)
        occ.append(inside)
        rgba.append(intersect.rgba_channels(inside, nx, ny, nz))
    return torch.cat(occ).reshape(n, n, n), torch.cat(rgba).reshape(n, n, n, 4)


def voxelize_parity_ref(verts_norm: torch.Tensor, tris: torch.Tensor,
                        n: int = 64, tri_chunk: int = 1024,
                        x_slab: int | None = None,
                        x_offset: int = 0) -> torch.Tensor:
    """Axis-parity solid voxelization oracle -> occupancy [x_slab,n,n] bool.

    Counts, per voxel column, the crossings strictly above each voxel center
    and takes the parity. ``x_slab``/``x_offset`` restrict it to the grid-x
    rows [x_offset, x_offset + x_slab) (default: all n), the unit of the
    sharded reference frame (parallel/shard.py).
    """
    device = verts_norm.device
    pt = parity_tri_setup(verts_norm, tris, n)
    x_slab = n if x_slab is None else x_slab
    # column centers in index space are the integers 0..n-1
    gx = (torch.arange(x_slab, dtype=torch.float32, device=device)
          + float(x_offset))[:, None, None]
    gy = torch.arange(n, dtype=torch.float32, device=device)[None, :, None]
    counts = torch.zeros((x_slab, n, n), dtype=torch.int32, device=device)
    for s in range(0, tris.shape[0], tri_chunk):
        ptc = type(pt)(*(x[s:s + tri_chunk] for x in pt))
        covered, m = column_crossing(ptc, gx, gy)  # [n,n,Tc]
        m = torch.clamp(m, 0, n)
        for k in range(n):
            counts[:, :, k] += (covered & (k < m)).sum(dim=-1, dtype=torch.int32)
    return (counts & 1).to(torch.bool)
