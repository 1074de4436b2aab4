"""Trilinear texture sampling (the LINEAR_CLAMP sampler analog).

Port of ``dxrvoxelizer_tpu/ops/sampling.py``. The reference samples its 3D
grid with a linear-clamp sampler (Content/Voxelizer.cpp:256,
PSRayCast.hlsl:106-108); here it is the explicit 8-tap gather with edge
clamping, used by the shader-exact renderer (ops/raymarch_ref.py). The order
of operations is the JAX package's: ``c = tex*n - 0.5``, floor, clamps, then
three lerp levels written as ``a + (b - a) * f``.
"""

from __future__ import annotations

import torch


def sample_trilinear(volume: torch.Tensor, tex: torch.Tensor) -> torch.Tensor:
    """Sample ``volume[Nx,Ny,Nz]`` at texture coords ``tex[...,3]`` in [0,1].

    D3D linear-clamp semantics: texel centers at (i+0.5)/N, coordinates
    clamped to the edge texels.
    """
    shape = torch.tensor(volume.shape, dtype=torch.int32, device=tex.device)
    c = tex * shape.to(tex.dtype) - 0.5
    c0 = torch.floor(c)
    f = c - c0
    ci = c0.to(torch.int32)
    i0 = torch.minimum(torch.clamp(ci, min=0), shape - 1).long()
    i1 = torch.minimum(torch.clamp(ci + 1, min=0), shape - 1).long()

    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    x1, y1, z1 = i1[..., 0], i1[..., 1], i1[..., 2]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]

    c000 = volume[x0, y0, z0]
    c100 = volume[x1, y0, z0]
    c010 = volume[x0, y1, z0]
    c110 = volume[x1, y1, z0]
    c001 = volume[x0, y0, z1]
    c101 = volume[x1, y0, z1]
    c011 = volume[x0, y1, z1]
    c111 = volume[x1, y1, z1]

    c00 = c000 + (c100 - c000) * fx
    c10 = c010 + (c110 - c010) * fx
    c01 = c001 + (c101 - c001) * fx
    c11 = c011 + (c111 - c011) * fx
    c0_ = c00 + (c10 - c00) * fy
    c1_ = c01 + (c11 - c01) * fy
    return c0_ + (c1_ - c0_) * fz
