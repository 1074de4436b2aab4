"""Grid conventions, bit packing, and texture-format emulation.

Grid convention (shared by every op in this package, identical to
``dxrvoxelizer_tpu/ops/packing.py``):

- The voxel grid is an array ``grid[i, j, k]`` with ``i`` the x texel, ``j``
  the y texel, ``k`` the z texel — exactly the ``RWTexture3D`` indexing of the
  reference (DXRVoxelizer.hlsl:84 ``RenderTarget[index]``).
- Voxel (i, j, k) has normalized-grid-space center
  ``p = ((i,j,k) + 0.5) / N * 2 - 1`` with ``p.y`` negated
  (DXRVoxelizer.hlsl:44-53 ``generateRay``), and texture-space center
  ``((i,j,k) + 0.5) / N``.

Packed occupancy: one bit per voxel packed along z into int32 words:
``occ_words[i, j, w]`` holds voxels ``k = 32w .. 32w+31`` (bit ``k & 31``).
"""

from __future__ import annotations

import numpy as np
import torch


def voxel_centers_norm(n: int):
    """Normalized-space voxel center coordinate arrays (cx[i], cy[j], cz[k])."""
    t = (np.arange(n, dtype=np.float32) + 0.5) / n * 2.0 - 1.0
    return t, (-t).astype(np.float32), t


def norm_to_index_space(p: torch.Tensor, n: int) -> torch.Tensor:
    """Map normalized-space points [-1,1]^3 -> continuous voxel-index space
    where voxel centers sit at integer coordinates (y axis flipped)."""
    # p * [n/2, -n/2, n/2] without a host-to-device copy (which would sync
    # the host on every deforming frame): negation is exact, so negating the
    # y product gives the same bits as multiplying by -n/2
    g = p * (0.5 * n)
    g[..., 1] = -g[..., 1]
    return g + (0.5 * n - 0.5)


def _shifts(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int64, device=device)


def pack_bits_z(occ: torch.Tensor) -> torch.Tensor:
    """Pack a boolean grid [N,N,N] (z minor) into int32 words [N,N,N//32]."""
    n = occ.shape[-1]
    assert n % 32 == 0, "grid size must be a multiple of 32 for packing"
    b = occ.to(torch.int64).reshape(*occ.shape[:-1], n // 32, 32)
    words = (b << _shifts(occ.device)).sum(dim=-1)  # < 2^32: exact in int64
    # reinterpret the low 32 bits as signed int32 (bit 31 -> sign)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_bits_z(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits_z` -> bool grid [N,N,N]."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    bits = (w[..., None] >> _shifts(words.device)) & 1
    return bits.reshape(*words.shape[:-1], n).to(torch.bool)


def quantize_r10g10b10a2(rgba: torch.Tensor) -> torch.Tensor:
    """Emulate a ``R10G10B10A2_UNORM`` store+load round trip.

    The reference grid texture is R10G10B10A2_UNORM (Content/Voxelizer.cpp:65):
    RGB in 10 bits, alpha in 2 bits, all clamped to [0,1].
    """
    rgb = torch.clamp(rgba[..., :3], 0.0, 1.0)
    a = torch.clamp(rgba[..., 3:], 0.0, 1.0)
    rgb_q = torch.round(rgb * 1023.0) / 1023.0
    a_q = torch.round(a * 3.0) / 3.0
    return torch.cat([rgb_q, a_q], dim=-1)
