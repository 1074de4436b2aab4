"""Trusted parity-voxelization oracle in plain torch.

Port of ``dxrvoxelizer_tpu/ops/voxelize_ref.py::voxelize_parity_ref``: axis-
aligned column rays with intersection-parity counting. This oracle *counts*
crossings per voxel; the CUDA kernel (ops/voxelize_cuda.py) folds XOR masks
and its plain version histograms cutoffs — independent reductions over the
identical per-triangle tests. The ray-stab oracles wait for the ray-stab
slice of the port.
"""

from __future__ import annotations

import torch

from dxrvoxelizer_tpu_torch.ops.geom import column_crossing, parity_tri_setup


def voxelize_parity_ref(verts_norm: torch.Tensor, tris: torch.Tensor,
                        n: int = 64, tri_chunk: int = 1024) -> torch.Tensor:
    """Axis-parity solid voxelization oracle -> occupancy [n,n,n] bool.

    Counts, per voxel column, the crossings strictly above each voxel center
    and takes the parity.
    """
    device = verts_norm.device
    pt = parity_tri_setup(verts_norm, tris, n)
    # column centers in index space are the integers 0..n-1
    gx = torch.arange(n, dtype=torch.float32, device=device)[:, None, None]
    gy = torch.arange(n, dtype=torch.float32, device=device)[None, :, None]
    counts = torch.zeros((n, n, n), dtype=torch.int32, device=device)
    for s in range(0, tris.shape[0], tri_chunk):
        ptc = type(pt)(*(x[s:s + tri_chunk] for x in pt))
        covered, m = column_crossing(ptc, gx, gy)  # [n,n,Tc]
        m = torch.clamp(m, 0, n)
        for k in range(n):
            counts[:, :, k] += (covered & (k < m)).sum(dim=-1, dtype=torch.int32)
    return (counts & 1).to(torch.bool)
