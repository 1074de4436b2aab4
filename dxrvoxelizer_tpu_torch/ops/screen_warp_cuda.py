"""Screen resolve with the screen mapping and the final composite fused in:
the CUDA kernel and its plain version.

Port of ``dxrvoxelizer_tpu/ops/screen_warp_pallas.py`` (kernel
``_resolve_kernel``, launcher ``bilinear_resolve``), with the screen mapping
(:func:`screen_coords`) and the final composite of
``raymarch_warp._shearwarp_core`` fused in. Each screen pixel finds where its
ray meets the intermediate plane and whether it hits the volume, bilinearly
samples the composited (scatter, transmit) intermediates there, clamped to
the edge, and turns them into an RGB value; pixels that miss the volume get
the clear colour.

- :func:`resolve_screen` is the wrapper: a CUDA tensor launches
  ``csrc/screen_warp.cu``; a CPU tensor takes the plain version.
- :func:`resolve_screen_plain` is :func:`screen_coords` plus
  :func:`resolve_plain` (``_bilinear_take`` plus the composite).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from dxrvoxelizer_tpu_torch.ops import _cuda
from dxrvoxelizer_tpu_torch.ops.raymarch_ref import TEX_SCALE
from dxrvoxelizer_tpu_torch.ops.warp import perm_for_axis

KERNEL = _cuda.Kernel(
    name="resolve",
    symbol="resolve_screen_kernel",
    source="dxrvoxelizer_tpu_torch/csrc/screen_warp.cu",
    replaces="dxrvoxelizer_tpu/ops/screen_warp_pallas.py:39",
)

_BIG = 3.402823466e38  # FLT_MAX: "no hit yet"
# csrc/screen_warp.cu ResolveArgs: scatter, transmit, out, gi_x, gi_y, ok
# (0: none) and the stream; then ScreenParams: screen_to_local (16), eye
# (3), tex scale (3); perm (3), flip, swap, m, width, height, y_off, pad;
# e_xy (2), c_ref, gmin (2), gext (2), clear colour (3)
_ARGS = struct.Struct("<7Q22f10i10f")
# per march axis: the tex scale and the permutation, adjacent in ScreenParams
_AXIS = {axis: (*(float(TEX_SCALE[p]) for p in perm_for_axis(axis)),
                *perm_for_axis(axis)) for axis in range(3)}


def screen_coords(screen_to_local: np.ndarray, eye_local: np.ndarray,
                  width: int, height: int, axis: int, flip: bool, m: int,
                  mi, device, y_off: int = 0) -> tuple[torch.Tensor, ...]:
    """Per-pixel intermediate coordinates (gi_x, gi_y) [H*W] and the hit
    mask ``ok`` — the ray/box entry test of ComputeStartPoint
    (PSRayCast.hlsl:71-98), planar per component. ``mi``: the frame's
    ``raymarch_warp.MarchInputs`` (its ``e_xy``, ``c_ref``, ``gmin`` and
    ``gext``). ``y_off``: the first screen row (a band of ``height`` rows;
    the JAX package adds it to the row centres in float32)."""
    s_m = np.asarray(screen_to_local, np.float32)
    eye = np.asarray(eye_local, np.float32)
    sx = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    sy = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    if y_off:
        sy = sy + float(y_off)
    px, py = torch.meshgrid(sx, sy, indexing="xy")  # [H, W]
    pxf = px.reshape(-1)
    pyf = py.reshape(-1)
    h = [pxf * float(s_m[0, c]) + pyf * float(s_m[1, c]) + float(s_m[3, c])
         for c in range(4)]
    pn = [h[c] / h[3] for c in range(3)]
    d = [pn[c] - float(eye[c]) for c in range(3)]
    d_len = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    dn = [d[c] / d_len for c in range(3)]

    inside = (
        (torch.abs(pn[0]) <= 1.0)
        & (torch.abs(pn[1]) <= 1.0)
        & (torch.abs(pn[2]) <= 1.0)
    )
    u_best = torch.full_like(pxf, _BIG)
    hit = torch.zeros_like(pxf, dtype=torch.bool)
    for i in range(3):
        j, k2 = (i + 1) % 3, (i + 2) % 3
        di = dn[i]
        nz = di != 0.0
        u = torch.where(
            nz, (-torch.sign(di) - pn[i]) / torch.where(nz, di, 1.0), _BIG
        )
        okc = (
            (u >= 0.0)
            & (torch.abs(dn[j] * u + pn[j]) <= 1.0)
            & (torch.abs(dn[k2] * u + pn[k2]) <= 1.0)
            & (u < u_best)
        )
        u_best = torch.where(okc, u, u_best)
        hit = hit | okc
    is_hit = inside | hit

    perm = perm_for_axis(axis)
    d_t = [dn[perm[c]] * float(TEX_SCALE[perm[c]]) for c in range(3)]
    if flip:
        d_t[2] = -d_t[2]
    dz = d_t[2]
    valid = torch.abs(dz) > 1e-6
    safe_dz = torch.where(valid, dz, 1.0)
    g_px = mi.e_xy[0] + mi.c_ref * d_t[0] / safe_dz
    g_py = mi.e_xy[1] + mi.c_ref * d_t[1] / safe_dz
    gi_x = (g_px - mi.gmin[0]) / mi.gext[0] * m - 0.5
    gi_y = (g_py - mi.gmin[1]) / mi.gext[1] * m - 0.5
    return gi_x, gi_y, is_hit & valid


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


def resolve_screen_plain(scatter_i, transmit_i, screen_to_local, eye_local,
                         clear_color, width: int, height: int, axis: int,
                         flip: bool, swap: bool, mi, y_off: int = 0):
    """Plain version: :func:`screen_coords` + :func:`resolve_plain` ->
    (image [H, W, 3], gi_x, gi_y, ok), ``height`` rows from screen row
    ``y_off``."""
    m = scatter_i.shape[0]
    gi_x, gi_y, ok = screen_coords(screen_to_local, eye_local, width, height,
                                   axis, flip, m, mi, scatter_i.device, y_off)
    if swap:  # intermediate rows then track screen rows
        img = resolve_plain(scatter_i.t().contiguous(),
                            transmit_i.t().contiguous(), gi_y, gi_x, ok,
                            clear_color, height, width)
    else:
        img = resolve_plain(scatter_i, transmit_i, gi_x, gi_y, ok,
                            clear_color, height, width)
    return img, gi_x, gi_y, ok


def resolve_screen(scatter_i, transmit_i, screen_to_local: np.ndarray,
                   eye_local: np.ndarray, clear_color, width: int, height: int,
                   axis: int, flip: bool, swap: bool, mi, coords: bool = False,
                   y_off: int = 0):
    """Map every screen pixel to the intermediates, resolve and composite ->
    [H, W, 3] f32, or (image, gi_x, gi_y, ok) with ``coords``; ``height``
    rows from screen row ``y_off`` (a band of a sharded frame: those rows of
    the whole image, bit for bit).

    ``scatter_i``/``transmit_i`` [M, M] f32, untransposed; the host statics
    ``screen_to_local`` [4, 4], ``eye_local`` [3] and ``clear_color`` [3]
    (numpy), ``axis``/``flip``/``swap`` (``shearwarp_statics``) and the
    frame's ``MarchInputs`` ``mi``. ``coords`` also returns the per-pixel
    coordinates and hit mask that :func:`screen_coords` computes (the
    checks read them). A CPU tensor takes the plain version.
    """
    if scatter_i.device.type == "cpu":
        out = resolve_screen_plain(scatter_i, transmit_i, screen_to_local,
                                   eye_local, clear_color, width, height,
                                   axis, flip, swap, mi, y_off)
        return out if coords else out[0]
    m = scatter_i.shape[0]
    # the one check the kernel needs, cheap on the common path; the reason
    # of a refusal comes from _cuda.require
    if not (scatter_i.is_cuda and transmit_i.is_cuda
            and scatter_i.dtype is torch.float32
            and transmit_i.dtype is torch.float32
            and scatter_i.shape == transmit_i.shape == (m, m)
            and scatter_i.is_contiguous() and transmit_i.is_contiguous()):
        _cuda.require(scatter_i, "scatter_i", torch.float32, (m, m))
        _cuda.require(transmit_i, "transmit_i", torch.float32, (m, m))
    dev = scatter_i.device
    out = torch.empty((height, width, 3), dtype=torch.float32, device=dev)
    extra = ()
    if coords:  # the kernel writes them only when given buffers
        p = height * width
        extra = (torch.empty(p, dtype=torch.float32, device=dev),
                 torch.empty(p, dtype=torch.float32, device=dev),
                 torch.empty(p, dtype=torch.bool, device=dev))
    lib = _cuda.load()
    args = _ARGS.pack(
        scatter_i.data_ptr(), transmit_i.data_ptr(), out.data_ptr(),
        *([t.data_ptr() for t in extra] or (0, 0, 0)), _cuda.stream_ptr(dev),
        *screen_to_local.ravel().tolist(), *eye_local.tolist(), *_AXIS[axis],
        flip, swap, m, width, height, y_off, 0, *mi.e_xy, mi.c_ref, *mi.gmin,
        *mi.gext,
        *clear_color.tolist(),
    )
    _cuda.check(lib.dxv_resolve_screen(args), KERNEL.name)
    KERNEL.launches += 1
    return (out, *extra) if coords else out
