"""Separable bilinear warp primitives (matmul-based).

Port of ``dxrvoxelizer_tpu/ops/warp.py``: resampling a 2D slab on a
scaled/translated grid is two small dense matmuls with 2-tap interpolation
matrices. Out-of-range taps get zero weight (outside the volume there is no
density), and the row-sum deficit is exposed so callers needing "outside
== 1" semantics (light transmittance) can add the complement. The plain
versions of the CUDA kernels use these; the march kernel rebuilds the same
two weights per pixel instead of reading the matrices.
"""

from __future__ import annotations

import torch


def perm_for_axis(axis: int) -> tuple[int, ...]:
    """Permutation moving ``axis`` last, keeping the other two in order."""
    rest = [a for a in range(3) if a != axis]
    return (*rest, axis)


def interp_matrix(coords: torch.Tensor, n_in: int) -> torch.Tensor:
    """Rows of 2-tap linear-interpolation weights.

    ``coords``: [..., M] input texel coordinates for each output sample.
    Returns W [..., M, n_in] with W @ values == linear interpolation, zero
    weight for taps outside [0, n_in-1].
    """
    c0 = torch.floor(coords)
    f = coords - c0
    i0 = c0.to(torch.int64)[..., None]
    i1 = i0 + 1
    cols = torch.arange(n_in, device=coords.device)
    hit0 = (cols == i0) & (i0 >= 0) & (i0 <= n_in - 1)
    hit1 = (cols == i1) & (i1 >= 0) & (i1 <= n_in - 1)
    zero = torch.zeros((), dtype=torch.float32, device=coords.device)
    w = torch.where(hit0, (1.0 - f)[..., None], zero)
    return w + torch.where(hit1, f[..., None], zero)


def scale_offset_coords(m_out: int, scale: torch.Tensor,
                        offset: torch.Tensor) -> torch.Tensor:
    """Input texel coords for output texel centers under x_in = scale*x_out+offset.

    ``scale``/``offset`` broadcast over leading dims (e.g. per slab).
    Output texel i has center i+0.5 in its own grid; returns [..., m_out].
    """
    i = torch.arange(m_out, dtype=torch.float32, device=scale.device) + 0.5
    return scale[..., None] * i + offset[..., None]


def warp2d(images: torch.Tensor, wx: torch.Tensor, wy: torch.Tensor) -> torch.Tensor:
    """Batched separable resample: out[k] = wx[k] @ images[k] @ wy[k]^T.

    images [K, Nx, Ny]; wx [K, Mx, Nx]; wy [K, My, Ny] -> [K, Mx, My].
    """
    return torch.matmul(torch.matmul(wx, images), wy.transpose(-1, -2))
