"""Fused shear-warp march: the CUDA kernel and its plain version.

Port of ``dxrvoxelizer_tpu/ops/march_pallas.py`` (kernel ``_march_kernel``,
launcher ``march_pallas``). Sub-slab s of KS = K*ss z-mixes the (density,
light) source slabs with weight ``wts[s]``, warps them to the M x M
intermediate, and composites front to back with the shader's absorption
rules (PSRayCast.hlsl:134-179).

The warp is given as each sub-slab's scale and offset (x_in = scale *
(i + 0.5) + offset per axis, ops/warp.py) instead of the dense [KS, M, N]
interpolation matrices of the TPU kernel: the CUDA kernel rebuilds the two
non-zero weights per pixel, the plain version builds the matrices.

- :func:`march` is the wrapper: a CUDA tensor launches ``csrc/march.cu``; a
  CPU tensor takes the plain version.
- :func:`march_plain` is the XLA path of the JAX package's
  ``_shearwarp_core``: z-lerp, ``warp2d`` through ``torch.matmul``, and the
  per-slab compositing loop.
"""

from __future__ import annotations

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


def march(slabs, wts, front, scale_x, off_x, scale_y, off_y, delta, ss: int):
    """Fused march -> (transmit [M, M], scatter [M, M]).

    ``slabs`` [2, K, N, N] f32 (density, light; far axis first); ``wts``,
    ``front``, ``scale_*``, ``off_*`` [K*ss] f32; ``delta`` [M, M] f32
    per-pixel step lengths. A CPU tensor takes the plain version.
    """
    if slabs.device.type == "cpu":
        return march_plain(slabs, wts, front, scale_x, off_x, scale_y, off_y,
                           delta, ss)
    kn, n = slabs.shape[1], slabs.shape[2]
    ks = kn * ss
    m = delta.shape[0]
    _cuda.require(slabs, "slabs", torch.float32, (2, kn, n, n))
    for name, t in (("wts", wts), ("front", front), ("scale_x", scale_x),
                    ("off_x", off_x), ("scale_y", scale_y), ("off_y", off_y)):
        _cuda.require(t, name, torch.float32, (ks,))
    _cuda.require(delta, "delta", torch.float32, (m, m))
    lib = _cuda.load()
    transmit = torch.empty((m, m), dtype=torch.float32, device=slabs.device)
    scatter = torch.empty((m, m), dtype=torch.float32, device=slabs.device)
    code = lib.dxv_march(
        slabs.data_ptr(), wts.data_ptr(), front.data_ptr(),
        scale_x.data_ptr(), off_x.data_ptr(), scale_y.data_ptr(),
        off_y.data_ptr(), delta.data_ptr(), transmit.data_ptr(),
        scatter.data_ptr(), kn, n, m, ss, _cuda.stream_ptr(slabs.device),
    )
    _cuda.check(code, KERNEL.name)
    KERNEL.launches += 1
    return transmit, scatter
