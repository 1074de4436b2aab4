"""Mip pyramid for the voxel grid (the GenerateMips / SHOW_MIP analog).

Port of ``dxrvoxelizer_tpu/ops/mips.py``. The reference samples its grid
with ``SampleLevel(g_smpLinear, tex, SHOW_MIP)`` (PSRayCast.hlsl:42-46):
level 0 in the shipped build, but the ``SHOW_MIP`` switch
(SharedConst.h:5) selects a coarser mip. Mips are 2x2x2 box averages of the
density channel; sampling "at level L" is rendering from the level-L grid,
since every ray-marcher here is resolution-independent (texture coordinates
in [0, 1]).

When the grid emulates the reference's R10G10B10A2_UNORM storage (the
non-USE_MUTEX mode), each level's alpha re-quantizes to 2 bits
(``quantize_alpha``); the float-grid mode (USE_MUTEX) averages smoothly.
"""

from __future__ import annotations

import torch


def downsample2(density: torch.Tensor) -> torch.Tensor:
    """One mip step: 2x2x2 box average [N,N,N] -> [N/2,N/2,N/2].

    The eight taps t0..t7 (row-major over the 2x2x2 box) are summed as
    ((((t0 + t1) + (t2 + t3)) + t4) + t5) + (t6 + t7), the order XLA:CPU's
    reduction takes in the JAX package (found by search against it), then
    divided by 8 (exact). The sum's order matters: a 2-bit requantization
    (:func:`quantize_a2`) rounds means of thirds that sit on a half.
    """
    n = density.shape[0]
    assert n % 2 == 0, f"grid size {n} not divisible by 2"
    x = density.reshape(n // 2, 2, n // 2, 2, n // 2, 2)
    t = [x[:, a, :, b, :, c] for a in range(2) for b in range(2)
         for c in range(2)]
    acc = ((t[0] + t[1]) + (t[2] + t[3])) + t[4]
    return ((acc + t[5]) + (t[6] + t[7])) / 8.0


def quantize_a2(density: torch.Tensor) -> torch.Tensor:
    """2-bit UNORM round trip of the alpha channel: {0, 1/3, 2/3, 1}.

    ``torch.round``, like ``jnp.round``, rounds half to even. The divisor
    is a tensor on the density's device: PyTorch's CUDA division by a
    Python scalar multiplies by its rounded reciprocal instead."""
    three = torch.tensor(3.0, dtype=density.dtype, device=density.device)
    return torch.round(torch.clamp(density, 0.0, 1.0) * 3.0) / three


def generate_mips(density: torch.Tensor, levels: int | None = None,
                  quantize_alpha: bool = False) -> tuple:
    """Full mip chain [N, N/2, ..., 1] of the density grid.

    Returns a tuple (level 0 = the input, possibly re-quantized). ``levels``
    limits the chain length (None = down to 1^3).
    """
    n = density.shape[0]
    max_levels = n.bit_length()  # N=64 -> 7 levels (64..1)
    levels = max_levels if levels is None else min(levels, max_levels)
    out = [quantize_a2(density) if quantize_alpha else density]
    for _ in range(levels - 1):
        d = downsample2(out[-1])
        out.append(quantize_a2(d) if quantize_alpha else d)
    return tuple(out)


def mip_level(density: torch.Tensor, level: int,
              quantize_alpha: bool = False) -> torch.Tensor:
    """The level-``level`` grid only (level 0 = full resolution)."""
    if level <= 0:
        return density
    return generate_mips(density, levels=level + 1,
                         quantize_alpha=quantize_alpha)[level]
