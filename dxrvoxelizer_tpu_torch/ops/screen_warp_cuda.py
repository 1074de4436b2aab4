"""Screen resolve + final composite: the CUDA kernel and its plain version.

Port of ``dxrvoxelizer_tpu/ops/screen_warp_pallas.py`` (kernel
``_resolve_kernel``, launcher ``bilinear_resolve``), with the final composite
of ``raymarch_warp._shearwarp_core`` fused in. Each screen pixel bilinearly
samples the composited (scatter, transmit) intermediates at (gi_x, gi_y),
clamped to the edge, and turns them into an RGB value; pixels that miss the
volume get the clear colour.

- :func:`resolve` is the wrapper: a CUDA tensor launches
  ``csrc/screen_warp.cu``; a CPU tensor takes the plain version.
- :func:`resolve_plain` is ``_bilinear_take`` plus the composite.
"""

from __future__ import annotations

import numpy as np
import torch

from dxrvoxelizer_tpu_torch.ops import _cuda

KERNEL = _cuda.Kernel(
    name="resolve",
    symbol="resolve_kernel",
    source="dxrvoxelizer_tpu_torch/csrc/screen_warp.cu",
    replaces="dxrvoxelizer_tpu/ops/screen_warp_pallas.py:39",
)


def bilinear_take(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  m: int) -> torch.Tensor:
    """Bilinear sample of img[x, y], clamped to the edge ([P] coordinates)."""
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, m - 1)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, m - 1)
    x1 = torch.clamp(x0 + 1, 0, m - 1)
    y1 = torch.clamp(y0 + 1, 0, m - 1)
    fx = torch.clamp(x - x0.to(torch.float32), 0.0, 1.0)
    fy = torch.clamp(y - y0.to(torch.float32), 0.0, 1.0)
    flat = img.reshape(-1)
    v00 = flat[x0 * m + y0]
    v10 = flat[x1 * m + y0]
    v01 = flat[x0 * m + y1]
    v11 = flat[x1 * m + y1]
    return (
        v00 * (1 - fx) * (1 - fy)
        + v10 * fx * (1 - fy)
        + v01 * (1 - fx) * fy
        + v11 * fx * fy
    )


def composite(sc: torch.Tensor, tr: torch.Tensor, ok: torch.Tensor,
              clear_color: np.ndarray) -> torch.Tensor:
    """Tone curve + clear-colour lerp per pixel -> [P, 3]
    (PSRayCast.hlsl:181-186, planar per channel)."""
    clear = torch.as_tensor(np.asarray(clear_color, np.float32), device=sc.device)
    base = sc * 0.8 + 0.2
    trc = torch.clamp(tr, 0.0, 1.0)
    cc2 = clear * clear
    chans = []
    for c in range(3):
        res_c = base + (cc2[c] - base) * trc
        rgb_c = torch.sqrt(torch.clamp(res_c, min=0.0))
        chans.append(torch.where(ok, rgb_c, clear[c]))
    return torch.stack(chans, dim=-1)


def resolve_plain(scatter_i, transmit_i, gi_x, gi_y, ok, clear_color,
                  height: int, width: int) -> torch.Tensor:
    """Plain torch resolve + composite -> [H, W, 3] f32."""
    m = scatter_i.shape[0]
    sc = bilinear_take(scatter_i, gi_x, gi_y, m)
    tr = bilinear_take(transmit_i, gi_x, gi_y, m)
    return composite(sc, tr, ok, clear_color).reshape(height, width, 3)


def resolve(scatter_i, transmit_i, gi_x, gi_y, ok, clear_color,
            height: int, width: int) -> torch.Tensor:
    """Resolve the [M, M] intermediates to the screen -> [H, W, 3] f32.

    ``gi_x``/``gi_y`` [H*W] f32 intermediate coordinates (row, column);
    ``ok`` [H*W] bool, pixels that hit the volume; ``clear_color`` [3].
    A CPU tensor takes the plain version.
    """
    if scatter_i.device.type == "cpu":
        return resolve_plain(scatter_i, transmit_i, gi_x, gi_y, ok,
                             clear_color, height, width)
    m = scatter_i.shape[0]
    p = height * width
    _cuda.require(scatter_i, "scatter_i", torch.float32, (m, m))
    _cuda.require(transmit_i, "transmit_i", torch.float32, (m, m))
    _cuda.require(gi_x, "gi_x", torch.float32, (p,))
    _cuda.require(gi_y, "gi_y", torch.float32, (p,))
    _cuda.require(ok, "ok", torch.bool, (p,))
    c = np.asarray(clear_color, np.float32)
    lib = _cuda.load()
    out = torch.empty((height, width, 3), dtype=torch.float32,
                      device=scatter_i.device)
    code = lib.dxv_resolve(
        scatter_i.data_ptr(), transmit_i.data_ptr(), gi_x.data_ptr(),
        gi_y.data_ptr(), ok.data_ptr(), out.data_ptr(), p, m,
        float(c[0]), float(c[1]), float(c[2]),
        _cuda.stream_ptr(scatter_i.device),
    )
    _cuda.check(code, KERNEL.name)
    KERNEL.launches += 1
    return out
