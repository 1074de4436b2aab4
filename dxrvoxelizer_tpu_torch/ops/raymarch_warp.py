"""Shear-warp volume renderer (port of ``dxrvoxelizer_tpu/ops/raymarch_warp.py``).

1. **Factorization.** Rays are parameterized by their intersection ``g`` with
   a fixed reference plane behind the volume (perpendicular to the view's
   major axis). A ray hits voxel slab k at
   ``p_xy = e_xy + s_k * (g_xy - e_xy)``, ``s_k = (z_k - e_z)/(z_ref - e_z)``
   — for a fixed slab this is a per-axis scale+translate of the slab image.
2. **Compositing** runs front-to-back over slabs on the intermediate grid
   with the shader's absorption rules (PSRayCast.hlsl:134-179). Steps 1 and
   2 are one fused CUDA kernel (ops/march_cuda.py).
3. **Light transmittance** comes from a slab-order recurrence along the
   light's major axis (:func:`light_sweep`, or the reference-step
   :func:`light_sweep_ref` of the ``-hq`` default: one launch each of the
   hand-written CUDA kernel ``csrc/light_sweep.cu`` on the card, as is the
   point light's perspective :func:`light_sweep_point`); where the
   recurrence does not apply (a light step under one slab, a light inside
   the volume) the exact per-voxel field of ops/raymarch_fast.py.
4. **Screen resolve**: each screen pixel finds where its ray meets the
   intermediate plane and whether it hits the volume, bilinearly reads the
   composited intermediate there and is composited to RGB — the second
   CUDA kernel, one launch per frame (ops/screen_warp_cuda.py).

Host-side statics (major axis, flip, intermediate size, light-step window)
stay numpy, as in the JAX package; the small per-slab vectors are computed
in float32 on the CPU and copied to the device in one transfer.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from dxrvoxelizer_tpu_torch.ops import _cuda, grid_cuda
from dxrvoxelizer_tpu_torch.ops.grid_cuda import to_slab_order as _to_slab_order
from dxrvoxelizer_tpu_torch.ops.march_cuda import (
    march,
    march_plain,
    march_ring,
    zmix_slabs,
)
from dxrvoxelizer_tpu_torch.ops.raymarch_fast import precompute_light_volume
from dxrvoxelizer_tpu_torch.ops.raymarch_ref import ABSORPTION, MAX_DIST, TEX_SCALE
from dxrvoxelizer_tpu_torch.ops.screen_warp_cuda import (
    resolve_screen,
    resolve_screen_plain,
)
from dxrvoxelizer_tpu_torch.ops.warp import (
    interp_matrix,
    perm_for_axis,
    scale_offset_coords,
)

LIGHT_SWEEP_REF = _cuda.Kernel(
    name="light_sweep_ref",
    symbol="light_sweep_kernel<true>",
    source="dxrvoxelizer_tpu_torch/csrc/light_sweep.cu",
    replaces="dxrvoxelizer_tpu/ops/raymarch_warp.py:272",
)
LIGHT_SWEEP = _cuda.Kernel(
    name="light_sweep",
    symbol="light_sweep_kernel<false>",
    source="dxrvoxelizer_tpu_torch/csrc/light_sweep.cu",
    replaces="dxrvoxelizer_tpu/ops/raymarch_warp.py:93",
)
LIGHT_SWEEP_POINT = _cuda.Kernel(
    name="light_sweep_point",
    symbol="light_sweep_point_kernel",
    source="dxrvoxelizer_tpu_torch/csrc/light_sweep.cu",
    replaces="dxrvoxelizer_tpu/ops/raymarch_warp.py:153",
)

Z_REF = 1.25  # reference plane (tex space), just past the far slab
S_MIN = 0.05  # near clipping for slabs almost at the eye plane


def _f32(x) -> torch.Tensor:
    """Host float32 tensor (the statics are computed on the CPU)."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


def _tex_params(consts_eye_local: np.ndarray, screen_to_local: np.ndarray,
                width: int, height: int):
    """Host-side static config: major axis, flip, and intermediate-axis swap.

    ``swap``: True when the first non-marching tex axis tracks screen-x more
    than screen-y (intermediate rows then follow screen rows).
    """
    def ray_dir(sx, sy):
        h = np.array([sx, sy, 0.0, 1.0], dtype=np.float32) @ screen_to_local
        p = h[:3] / h[3]
        w = p - consts_eye_local
        return w / np.linalg.norm(w)

    w_tex = TEX_SCALE * ray_dir(width * 0.5, height * 0.5)
    axis = int(np.argmax(np.abs(w_tex)))
    flip = bool(w_tex[axis] < 0)
    rest = [a for a in range(3) if a != axis]
    ddx = TEX_SCALE * (ray_dir(width * 0.5 + 8, height * 0.5) - ray_dir(width * 0.5, height * 0.5))
    ddy = TEX_SCALE * (ray_dir(width * 0.5, height * 0.5 + 8) - ray_dir(width * 0.5, height * 0.5))
    swap = bool(abs(ddx[rest[0]]) > abs(ddy[rest[0]]))
    return axis, flip, swap


def _from_slab_order(vol: torch.Tensor, perm, flip: bool) -> torch.Tensor:
    """Inverse of :func:`_to_slab_order`."""
    v = vol.movedim(0, -1)
    if flip:
        v = v.flip(-1)
    return v.permute(*np.argsort(perm).tolist()).contiguous()


def _light_key(light_local) -> tuple[float, float, float]:
    """The light vector as float32 values (the statics' cache key)."""
    return tuple(float(v) for v in
                 np.asarray(light_local, np.float32).reshape(3).tolist())


@functools.lru_cache(maxsize=256)
def _dir_statics(light: tuple, n: int, axis: int,
                 flip: bool) -> tuple[float, float, float]:
    """Host statics of :func:`light_sweep`, float32 on the CPU: the per-slab
    shift (texels) along slab x and y and ABSORPTION times the step
    length."""
    light_t = _f32(light)
    ld_n = light_t / torch.linalg.norm(light_t)
    ld_t = _f32(TEX_SCALE) * ld_n
    ld = ld_t[list(perm_for_axis(axis))]
    if flip:
        ld = ld * _f32([1.0, 1.0, -1.0])
    # per-slab constant shift (texels) and normalized-space step length
    shift_x = (ld[0] / ld[2]).item()
    shift_y = (ld[1] / ld[2]).item()
    delta_l = (2.0 / n) * torch.linalg.norm(ld_n) / torch.clamp(
        torch.abs(ld[2]), min=1e-6
    )
    return shift_x, shift_y, (ABSORPTION * delta_l).item()


@functools.lru_cache(maxsize=256)
def _point_statics(light: tuple, axis: int,
                   flip: bool) -> tuple[float, float, float]:
    """Host statics of :func:`light_sweep_point`: the light point ``l_t``
    in slab-order tex space as (l_x, l_y, l_z), float32 values computed on
    the CPU with the plain version's operations (l_z reflected when
    ``flip``)."""
    l_t = (_f32(TEX_SCALE) * _f32(light) + 0.5)[list(perm_for_axis(axis))]
    if flip:
        l_t = l_t * _f32([1.0, 1.0, -1.0]) + _f32([0.0, 0.0, 1.0])
    return tuple(v.item() for v in l_t)


# ---- the kernel's launch (csrc/light_sweep.cu) -----------------------------

FLAGS_MAX = 4096  # blocks of a launch, at most: a 64-bit flag each
SCRATCH_WORDS = 32 + 2 * FLAGS_MAX  # the epoch and a count, then the flags


def sweep_threads(n: int, ref: bool, d0: int) -> int:
    """Threads per block of a launch (``threads_for`` in
    csrc/light_sweep.cu): 128 up to 16,384 voxels a step (X.3: d0 slabs,
    X.4 and X.5: one), else 256."""
    return 128 if (d0 if ref else 1) * n * n <= 16384 else 256


@functools.lru_cache(maxsize=None)
def _scratch(device: torch.device, stream: int) -> torch.Tensor:
    """The launch's scratch: SCRATCH_WORDS zeroed words per device and
    stream, allocated once (the kernel tags its flags with an epoch it
    advances itself, so nothing is reset between launches)."""
    return torch.zeros(SCRATCH_WORDS, dtype=torch.int32, device=device)


def _launch(kernel: _cuda.Kernel, entry: str, density: torch.Tensor, n: int,
            *args) -> torch.Tensor:
    """One cooperative launch of ``csrc/light_sweep.cu`` through its C entry
    point ``entry`` (``args``: the entry's arguments between ``n`` and the
    stream) -> [N,N,N]."""
    density = density.contiguous()
    _cuda.require(density, "density", torch.float32, (n, n, n))
    lib = _cuda.load()
    out = torch.empty((n, n, n), dtype=torch.float32, device=density.device)
    stream = _cuda.stream_ptr(density.device)
    code = getattr(lib, entry)(
        density.data_ptr(), out.data_ptr(),
        _scratch(density.device, stream).data_ptr(), n, *args, stream)
    _cuda.check(code, kernel.name)
    kernel.launches += 1
    return out


def light_sweep_plain(density: torch.Tensor, light_local: np.ndarray,
                      n: int, axis: int, flip: bool) -> torch.Tensor:
    """Plain version of :func:`light_sweep`: the JAX package's scan as a
    loop of torch ops (dense [n, n] interpolation matrices), on any
    device."""
    device = density.device
    shift_x, shift_y, absl = _dir_statics(_light_key(light_local), n, axis,
                                          flip)
    perm = perm_for_axis(axis)
    dens = _to_slab_order(density, perm, flip)  # [K, X, Y]

    i = torch.arange(n, dtype=torch.float32, device=device)
    wx = interp_matrix(i + shift_x, n)  # [n, n]
    wy = interp_matrix(i + shift_y, n)
    wsum = wx.sum(-1)[:, None] * wy.sum(-1)[None, :]  # [n, n]

    g = torch.clamp(dens * 8.0, max=16.0)
    att = torch.clamp(1.0 - absl * g, 0.0, 1.0)

    lvol = torch.empty((n, n, n), dtype=torch.float32, device=device)
    carry = torch.ones((n, n), dtype=torch.float32, device=device)
    wy_t = wy.t()
    for k in range(n - 1, -1, -1):
        # carry = L[k+1] * att[k+1] field; produce L[k]
        l_k = wx @ carry @ wy_t + (1.0 - wsum)
        lvol[k] = l_k
        carry = l_k * att[k]
    return _from_slab_order(lvol, perm, flip)


def light_sweep(density: torch.Tensor, light_local: np.ndarray,
                n: int, axis: int, flip: bool,
                use_kernel: bool = True) -> torch.Tensor:
    """Directional light-transmittance volume by slab recurrence -> [N,N,N].

    The ``-fast`` mode's light field. ``axis``/``flip``: the light
    direction's major tex axis and sign (:func:`light_statics`). A CUDA
    tensor launches ``csrc/light_sweep.cu`` (X.4) once, or raises; a CPU
    tensor, or ``use_kernel=False``, takes :func:`light_sweep_plain`.
    """
    if not use_kernel or density.device.type == "cpu":
        return light_sweep_plain(density, light_local, n, axis, flip)
    shift_x, shift_y, absl = _dir_statics(_light_key(light_local), n, axis,
                                          flip)
    return _launch(LIGHT_SWEEP, "dxv_light_sweep", density, n, 0, axis,
                   int(flip), 1, 0.0, shift_x, shift_y, absl,
                   0, n - 1, 0, n - 1, n - 1)


def light_sweep_point_plain(density: torch.Tensor, light_local: np.ndarray,
                            n: int, axis: int, flip: bool) -> torch.Tensor:
    """Plain version of :func:`light_sweep_point`: the JAX package's scan
    as a loop of torch ops (dense [K, n, n] interpolation matrices and a
    per-voxel step length), on any device. The matmuls are FP32 (no TF32
    on the card)."""
    if density.is_cuda:
        assert not torch.backends.cuda.matmul.allow_tf32, "the sweep is FP32"
    device = density.device
    perm = perm_for_axis(axis)
    dens = _to_slab_order(density, perm, flip)  # [K, X, Y]
    l_t = (_f32(TEX_SCALE) * _f32(light_local) + 0.5)[list(perm)]
    if flip:
        l_t = l_t * _f32([1.0, 1.0, -1.0]) + _f32([0.0, 0.0, 1.0])
    lx, ly, lz = (v.to(device) for v in l_t)

    # the divisor is a tensor on the density's device: PyTorch's CUDA
    # division by a Python scalar multiplies by its rounded reciprocal, and
    # near the far face the tap map is ill-conditioned (2.4e-4 apart at
    # 160^3)
    n_t = torch.tensor(float(n), dtype=torch.float32, device=device)
    k = torch.arange(n, dtype=torch.float32, device=device)
    z_k = (k + 0.5) / n_t
    # slab k reads the carry field at its light-ray crossing of slab k+1:
    # q = l + a_k (p - l), a_k = (z_{k+1}-lz)/(z_k-lz); the last slab's map
    # is arbitrary (the carry is all-ones there)
    z_next = torch.cat([z_k[1:], torch.full((1,), (n + 0.5) / n,
                                            dtype=torch.float32, device=device)])
    a_k = (z_next - lz) / (z_k - lz)  # [K]
    wx = interp_matrix(scale_offset_coords(n, a_k, n * lx * (1.0 - a_k) - 0.5),
                       n)  # [K, n, n]
    wy = interp_matrix(scale_offset_coords(n, a_k, n * ly * (1.0 - a_k) - 0.5),
                       n)

    # per-voxel crossing length in normalized-space units (the obliquity
    # ratio is scale-invariant, so tex-space components work directly)
    x_t = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n_t
    dx2 = (x_t[:, None] - lx) ** 2  # [X, 1]
    dy2 = (x_t[None, :] - ly) ** 2  # [1, Y]
    dz = z_k - lz  # [K]
    delta = (2.0 / n) * torch.sqrt(
        dx2[None] + dy2[None] + (dz**2)[:, None, None]
    ) / torch.abs(dz)[:, None, None]  # [K, X, Y]

    g = torch.clamp(dens * 8.0, max=16.0)
    att = torch.clamp(1.0 - ABSORPTION * delta * g, 0.0, 1.0)  # [K, X, Y]

    lvol = torch.empty((n, n, n), dtype=torch.float32, device=device)
    carry = torch.ones((n, n), dtype=torch.float32, device=device)
    for s in range(n - 1, -1, -1):
        wsum = wx[s].sum(-1)[:, None] * wy[s].sum(-1)[None, :]
        l_k = wx[s] @ carry @ wy[s].t() + (1.0 - wsum)
        lvol[s] = l_k
        carry = l_k * att[s]
    return _from_slab_order(lvol, perm, flip)


def light_sweep_point(density: torch.Tensor, light_local: np.ndarray,
                      n: int, axis: int, flip: bool,
                      use_kernel: bool = True) -> torch.Tensor:
    """Point-light transmittance volume by perspective slab sweep -> [N,N,N].

    The _POINT_LIGHT_ variant of :func:`light_sweep` (PSRayCast.hlsl:151-154):
    rays emanate from the light POINT, so the per-slab resample is a
    scale+offset toward the light's xy instead of a constant shift, and the
    per-crossing path length varies per voxel (``(2/N)*|p-l|/|p_z-l_z|``).
    Requires the light outside the volume beyond the ``axis``/``flip`` side
    (:func:`light_sweep_point_host` checks and takes the exact per-voxel
    field otherwise; the kernel raises).

    A CUDA tensor launches ``csrc/light_sweep.cu`` (X.5) once, or raises; a
    CPU tensor, or ``use_kernel=False``, takes
    :func:`light_sweep_point_plain`.
    """
    if not use_kernel or density.device.type == "cpu":
        return light_sweep_point_plain(density, light_local, n, axis, flip)
    return _launch(LIGHT_SWEEP_POINT, "dxv_light_sweep_point", density, n,
                   axis, int(flip),
                   *_point_statics(_light_key(light_local), axis, flip),
                   ABSORPTION)


def point_light_statics(light_local: np.ndarray,
                        n: int) -> tuple[int, bool, bool]:
    """Host statics of the point light's field: ``(axis, flip, sweep)``,
    the light's major tex axis and side, and whether it lies more than a
    texel beyond that face (the perspective sweep; else the exact per-voxel
    field)."""
    l_t = np.asarray(TEX_SCALE) * np.asarray(light_local) + 0.5
    axis = int(np.argmax(np.abs(l_t - 0.5)))
    flip = bool(l_t[axis] < 0.5)
    lz = 1.0 - l_t[axis] if flip else l_t[axis]
    return axis, flip, bool(lz > 1.0 + 1.0 / n)


def light_sweep_point_host(density: torch.Tensor, light_local: np.ndarray,
                           n: int, use_kernel: bool = True) -> torch.Tensor:
    """Point-light field: perspective sweep when the light clears the
    volume along its major axis, else the exact per-voxel march
    (:func:`~dxrvoxelizer_tpu_torch.ops.raymarch_fast.precompute_light_volume`);
    ``use_kernel=False`` takes the plain versions."""
    light_local = np.asarray(light_local)
    axis, flip, sweep = point_light_statics(light_local, n)
    if not sweep:
        return precompute_light_volume(density, light_local, point_light=True,
                                       use_kernel=use_kernel)
    return light_sweep_point(density, light_local, n, axis, flip,
                             use_kernel=use_kernel)


def light_statics(light_local: np.ndarray) -> tuple[int, bool]:
    """Host-side light statics: the light direction's major tex axis+sign."""
    light_local = np.asarray(light_local)
    ld_t = np.asarray(TEX_SCALE) * (light_local / np.linalg.norm(light_local))
    axis = int(np.argmax(np.abs(ld_t)))
    flip = bool(ld_t[axis] < 0)
    return axis, flip


def light_ref_statics(light_local: np.ndarray, n: int,
                      n_light: int = 32) -> tuple[int, bool, int]:
    """Host statics for :func:`light_sweep_ref`: (axis, flip, d0).

    ``d0`` = whole slabs per reference light step along the major axis
    (the recurrence's window size). d0 == 0 means the step spans less than
    one slab (tiny grids), which needs the exact per-voxel field.
    """
    light_local = np.asarray(light_local)
    ld = light_local / np.linalg.norm(light_local)
    s_t = np.asarray(TEX_SCALE) * ld * (MAX_DIST / n_light)
    axis = int(np.argmax(np.abs(s_t)))
    flip = bool(s_t[axis] < 0)
    d0 = int(np.floor(abs(s_t[axis]) * n))
    return axis, flip, d0


@dataclass(frozen=True)
class RefStatics:
    """Host statics of :func:`light_sweep_ref`, float32 values computed on
    the CPU with the plain version's operations."""

    w: float  # fractional slabs per step: the farther slab's z-mix weight
    shift: tuple[float, float]  # the step's slab x and y in texels
    s: tuple[float, float, float]  # the step in slab-order tex space
    absl: float  # ABSORPTION * the step length, as float32
    # texels whose p+s lies inside the box: slab x in [xlo, xhi], slab y in
    # [ylo, yhi], slabs 0..kmax (voxel centres shift by the constant step,
    # so each axis's inside set is an interval)
    box: tuple[int, int, int, int, int]


def _interval(inside: torch.Tensor) -> tuple[int, int]:
    """(first, last) index of a mask that is one interval; (0, -1) empty."""
    idx = torch.nonzero(inside).reshape(-1).tolist()
    if not idx:
        return 0, -1
    if len(idx) != idx[-1] - idx[0] + 1:
        raise AssertionError("the inside texels are not an interval")
    return idx[0], idx[-1]


@functools.lru_cache(maxsize=256)
def ref_statics(light: tuple, n: int, axis: int, flip: bool, d0: int,
                n_light: int = 32) -> RefStatics:
    """:class:`RefStatics` of the light vector ``light`` (float32 values,
    a tuple: the cache key) for :func:`light_ref_statics`' axis, flip and
    d0."""
    ls = MAX_DIST / n_light
    light_t = _f32(light)
    ld = light_t / torch.linalg.norm(light_t)
    s_full = _f32(TEX_SCALE) * ld * ls  # tex-space step vector
    s_t = s_full[list(perm_for_axis(axis))]
    if flip:
        s_t = s_t * _f32([1.0, 1.0, -1.0])
    delta = s_t[2] * n  # slabs per step (> 0 by flip), d0 = floor(delta)
    s0, s1, s2 = (v.item() for v in s_t)
    # the plain version's mask expressions (:func:`light_sweep_ref_plain`)
    i = torch.arange(n, dtype=torch.float32)
    c = (i + 0.5) / n
    xlo, xhi = _interval(((c + s0) >= 0.0) & ((c + s0) <= 1.0))
    ylo, yhi = _interval(((c + s1) >= 0.0) & ((c + s1) <= 1.0))
    klo, khi = _interval(c + s2 <= 1.0)
    if khi >= 0 and klo != 0:
        raise AssertionError("the inside slabs do not start at slab 0")
    return RefStatics(
        w=(delta - d0).item(), shift=((s_t[0] * n).item(), (s_t[1] * n).item()),
        s=(s0, s1, s2), absl=float(np.float32(ABSORPTION * ls)),
        box=(xlo, xhi, ylo, yhi, khi))


def light_sweep_ref_plain(density: torch.Tensor, light_local: np.ndarray,
                          n: int, axis: int, flip: bool, d0: int,
                          n_light: int = 32) -> torch.Tensor:
    """Plain version of :func:`light_sweep_ref`: the JAX package's blocked
    recurrence op for op, on any device.

    Slab k reads only slabs k+d0 and k+d0+1, so d0 consecutive slabs have
    no dependence on each other and each block is resampled with two
    batched matmuls of dense interpolation matrices.
    """
    assert d0 >= 1, "light step spans < 1 slab; use the exact field"
    device = density.device
    ls = MAX_DIST / n_light
    st = ref_statics(_light_key(light_local), n, axis, flip, d0, n_light)
    w = st.w  # fractional part
    s0, s1, s2 = st.s
    sx, sy = st.shift  # xy shift in texels (constant across slabs)
    perm = perm_for_axis(axis)
    dvol = _to_slab_order(density, perm, flip)  # [K, X, Y]

    i = torch.arange(n, dtype=torch.float32, device=device)
    coords_x = i + sx
    coords_y = i + sy
    # L resample: zero-weight outside + complement (outside the volume the
    # transmittance is 1 — nothing absorbs)
    wx_l = interp_matrix(coords_x, n)  # [n, n]
    wy_l = interp_matrix(coords_y, n)
    corr_l = 1.0 - wx_l.sum(-1)[:, None] * wy_l.sum(-1)[None, :]
    # density resample: LINEAR_CLAMP (the sampler clamps the coordinate)
    wx_d = interp_matrix(torch.clamp(coords_x, 0.0, n - 1.0), n)
    wy_d = interp_matrix(torch.clamp(coords_y, 0.0, n - 1.0), n)

    # exact per-texel out-of-box mask for p+s (voxel centers are exactly
    # (i+0.5)/n, the shift is constant)
    px = (i + 0.5) / n + s0
    py = (i + 0.5) / n + s1
    in_xy = ((px >= 0.0) & (px <= 1.0))[:, None] & (
        (py >= 0.0) & (py <= 1.0)
    )[None, :]  # [X, Y]
    in_z = (i + 0.5) / n + s2 <= 1.0  # [K] (s_z > 0: lower bound holds)

    # attenuation at p+s for every slab (batched): z-mix with CLAMP
    # indices, then the shared xy warp
    ki = torch.arange(n, device=device)
    z0 = torch.clamp(ki + d0, 0, n - 1)
    z1 = torch.clamp(ki + d0 + 1, 0, n - 1)
    dmix = dvol[z0] * (1.0 - w) + dvol[z1] * w  # [K, X, Y]
    dres = torch.matmul(wx_d, dmix)  # [K, X', Y]
    dres = torch.matmul(dres, wy_d.t())  # [K, X', Y']
    g = torch.clamp(dres * 8.0, max=16.0)
    att = torch.clamp(1.0 - ABSORPTION * ls * g, 0.0, 1.0)  # [K, X, Y]
    mask = in_xy[None] & in_z[:, None, None]  # [K, X, Y]

    # far-to-near in reversed slab space r = n-1-k: slab r reads r-d0-1
    # (weight w) and r-d0 (weight 1-w), both strictly earlier outputs.
    # Padding slabs at the near end are masked to 1 and sliced off.
    attr = att.flip(0)
    maskr = mask.flip(0)
    nb = -(-n // d0)
    out = torch.empty((nb * d0, n, n), dtype=torch.float32, device=device)
    one = torch.ones((), dtype=torch.float32, device=device)
    wy_lt = wy_l.t()
    # carry[i] = L[(b-1)*d0 - 1 + i], i in [0, d0]
    carry = torch.ones((d0 + 1, n, n), dtype=torch.float32, device=device)
    for b in range(nb):
        lo, hi = b * d0, min((b + 1) * d0, n)
        lmix = carry[1:] * (1.0 - w) + carry[:-1] * w
        lres = torch.matmul(torch.matmul(wx_l, lmix), wy_lt) + corr_l
        l_b = torch.where(maskr[lo:hi], attr[lo:hi] * lres[: hi - lo], one)
        if hi - lo < d0:  # partial last block: padding slabs are 1
            l_b = torch.cat([l_b, one.expand(d0 - (hi - lo), n, n)])
        out[b * d0:(b + 1) * d0] = l_b
        carry = torch.cat([carry[-1:], l_b], dim=0)
    lvol = out[:n].flip(0)  # [K, X, Y]
    return _from_slab_order(lvol, perm, flip)


def light_sweep_ref(density: torch.Tensor, light_local: np.ndarray,
                    n: int, axis: int, flip: bool, d0: int,
                    n_light: int = 32,
                    use_kernel: bool = True) -> torch.Tensor:
    """REFERENCE-step directional light field -> [N,N,N] transmittance.

    The reference's light loop (PSRayCast.hlsl:156-173) marches ``n_light``
    steps of constant vector ``s = dir * MAX_DIST/n_light`` toward the light;
    its product obeys ``L(p) = att(p+s) * L(p+s)``, computed far-to-near on
    the slab grid along the step's major tex axis: ``att(p+s)`` from the
    trilinearly resampled density (LINEAR_CLAMP), ``L(p+s)`` from a 2-slab
    z-mix of computed L slabs with out-of-volume reads contributing 1, and
    L = 1 where p+s leaves the box (the loop's first-step break).
    ``d0 >= 1`` required (:func:`light_ref_statics`).

    A CUDA tensor launches ``csrc/light_sweep.cu`` (X.3) once, or raises; a
    CPU tensor, or ``use_kernel=False``, takes :func:`light_sweep_ref_plain`.
    """
    if not use_kernel or density.device.type == "cpu":
        return light_sweep_ref_plain(density, light_local, n, axis, flip, d0,
                                     n_light=n_light)
    if d0 < 1:
        raise ValueError("light step spans < 1 slab; use the exact field")
    st = ref_statics(_light_key(light_local), n, axis, flip, d0, n_light)
    return _launch(LIGHT_SWEEP_REF, "dxv_light_sweep", density, n, 1, axis,
                   int(flip), d0, st.w, *st.shift, st.absl, *st.box)


def light_sweep_ref_host(density: torch.Tensor, light_local: np.ndarray,
                         n: int, n_light: int = 32,
                         use_kernel: bool = True) -> torch.Tensor:
    """Reference-step light field: the blocked recurrence when the step
    spans >= 1 slab, else the exact per-voxel march (tiny grids).
    ``use_kernel=False`` takes the plain versions."""
    axis, flip, d0 = light_ref_statics(light_local, n, n_light)
    if d0 < 1:
        return precompute_light_volume(density, light_local, n_light=n_light,
                                       use_kernel=use_kernel)
    return light_sweep_ref(density, light_local, n, axis, flip, d0,
                           n_light=n_light, use_kernel=use_kernel)


def light_sweep_host(density: torch.Tensor, light_local: np.ndarray,
                     n: int, use_kernel: bool = True) -> torch.Tensor:
    axis, flip = light_statics(light_local)
    return light_sweep(density, light_local, n, axis, flip,
                       use_kernel=use_kernel)


@dataclass
class MarchInputs:
    """Operands of the fused march (ops/march_cuda.march) plus the
    intermediate-plane geometry the screen resolve needs."""

    slabs: torch.Tensor  # [2, K, N, N] (density, light), far axis first
    wts: torch.Tensor  # [KS] z-mix weights
    front: torch.Tensor  # [KS] near-clip mask (0/1)
    scale_x: torch.Tensor  # [KS] x_in = scale * (i + 0.5) + off, per slab
    off_x: torch.Tensor
    scale_y: torch.Tensor
    off_y: torch.Tensor
    delta: torch.Tensor  # [M, M] per-pixel step length
    ss: int
    e_xy: tuple[float, float]  # eye in permuted tex space
    c_ref: float  # reference-plane distance from the eye
    gmin: tuple[float, float]  # intermediate footprint on the plane
    gext: tuple[float, float]
    ring: tuple[int, int, int]  # the march kernel's ring (march_cuda.march_ring)

    def args(self) -> tuple:
        return (self.slabs, self.wts, self.front, self.scale_x, self.off_x,
                self.scale_y, self.off_y, self.delta, self.ss)


def march_inputs(density: torch.Tensor, light_vol: torch.Tensor,
                 eye_local: np.ndarray, n: int, m: int, axis: int, flip: bool,
                 ss: int, use_kernel: bool = True) -> MarchInputs:
    """Slab stack (X.8, ops/grid_cuda.py: the kernel on CUDA tensors, its
    plain version on CPU ones or with ``use_kernel=False``), per-(sub-)slab
    warp parameters and step lengths."""
    device = density.device
    perm = perm_for_axis(axis)
    slabs = grid_cuda.slabs(density, light_vol, axis, flip,
                            use_kernel=use_kernel)  # [2, K, X, Y]

    # ``ss``: z-supersampling factor; ss > 1 marches n*ss sub-slabs whose
    # planes are z-LERPed between adjacent voxel slabs (LINEAR_CLAMP), so
    # every sub-slab sample is fully trilinear (PSRayCast.hlsl:103-112)
    ks = n * ss
    cpu = torch.device("cpu")
    wts = zmix_slabs(n, ss, cpu)[2] if ss > 1 else torch.zeros(ks)

    e_t_full = (_f32(TEX_SCALE) * _f32(eye_local) + 0.5)[list(perm)]
    if flip:
        e_t_full = e_t_full * _f32([1.0, 1.0, -1.0]) + _f32([0.0, 0.0, 1.0])
    e_xy = e_t_full[:2]
    e_z = e_t_full[2]
    c_ref = Z_REF - e_z  # positive whenever the volume is in front

    # intermediate footprint: box corners projected from the eye to the
    # reference plane (slabs closer than S_MIN*c_ref are near-clipped)
    corners = _f32([0.0, 1.0])
    c_z = torch.maximum(corners - e_z, S_MIN * c_ref)  # [2]
    scale_c = c_ref / c_z  # [2]
    gx_c = e_xy[0] + (corners[:, None] - e_xy[0]) * scale_c[None, :]
    gy_c = e_xy[1] + (corners[:, None] - e_xy[1]) * scale_c[None, :]
    gmin = torch.stack([gx_c.min(), gy_c.min()])
    gmax = torch.stack([gx_c.max(), gy_c.max()])
    gext = gmax - gmin

    # per-(sub-)slab warp parameters
    z_k = (torch.arange(ks, dtype=torch.float32) + 0.5) / ks
    s_k = torch.clamp((z_k - e_z) / c_ref, min=0.0)  # <=0: behind the eye
    scale_x = s_k * gext[0] * n / m
    off_x = n * (e_xy[0] + s_k * (gmin[0] - e_xy[0])) - 0.5
    scale_y = s_k * gext[1] * n / m
    off_y = n * (e_xy[1] + s_k * (gmin[1] - e_xy[1])) - 0.5
    front = (s_k > S_MIN).to(torch.float32)  # near-clip mask per slab

    # per-intermediate-pixel step length (normalized-space units; the
    # tex -> normalized scale is uniform, so the obliquity ratio is
    # computable in tex space directly)
    gi = (torch.arange(m, dtype=torch.float32) + 0.5) / m
    w_x = (gmin[0] + gi * gext[0] - e_xy[0])[:, None]
    w_y = (gmin[1] + gi * gext[1] - e_xy[1])[None, :]
    delta = (2.0 / ks) * torch.sqrt(w_x**2 + w_y**2 + c_ref**2) / torch.abs(c_ref)

    vec = torch.stack([wts, front, scale_x, off_x, scale_y, off_y]).to(device)
    return MarchInputs(
        slabs, *vec.unbind(0), delta.to(device), ss,
        e_xy=(e_xy[0].item(), e_xy[1].item()), c_ref=c_ref.item(),
        gmin=(gmin[0].item(), gmin[1].item()),
        gext=(gext[0].item(), gext[1].item()),
        ring=march_ring(scale_x, off_x, scale_y, off_y, m, n, ss),
    )


def _shearwarp_core(
    density: torch.Tensor,
    light_vol: torch.Tensor,
    screen_to_local: np.ndarray,
    eye_local: np.ndarray,
    clear_color: np.ndarray,
    n: int,
    m: int,
    width: int,
    height: int,
    axis: int,
    flip: bool,
    swap: bool,
    ss: int = 1,
    use_kernels: bool = True,
    y_off: int = 0,
) -> torch.Tensor:
    """March + resolve one frame -> [H, W, 3] f32. ``use_kernels=False``
    runs the plain versions of both kernels (on any device). ``y_off``: the
    first screen row of a band of ``height`` rows (a rank's share of a
    sharded frame; the march is the whole intermediate on every rank, as in
    the JAX package)."""
    mi = march_inputs(density, light_vol, eye_local, n, m, axis, flip, ss,
                      use_kernel=use_kernels)
    statics = (screen_to_local, eye_local, clear_color, width, height, axis,
               flip, swap, mi)
    if use_kernels:
        transmit_i, scatter_i = march(*mi.args(), ring=mi.ring)
        return resolve_screen(scatter_i, transmit_i, *statics, y_off=y_off)
    transmit_i, scatter_i = march_plain(*mi.args())
    return resolve_screen_plain(scatter_i, transmit_i, *statics, y_off)[0]


def _box_screen_px(screen_to_local: np.ndarray, width: int, height: int) -> float:
    """Host estimate of the volume's screen-space extent in pixels."""
    l2s = np.linalg.inv(screen_to_local.astype(np.float64))
    corners = np.array(
        [[x, y, z, 1.0] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
        dtype=np.float64,
    )
    s = corners @ l2s
    w_ok = np.abs(s[:, 3]) > 1e-9
    if not w_ok.any():
        return float(max(width, height))
    p = s[w_ok, :2] / s[w_ok, 3:4]
    ext = p.max(axis=0) - p.min(axis=0)
    return float(np.clip(max(ext[0], ext[1]), 16.0, 4096.0))


def shearwarp_statics(
    screen_to_local,
    eye_local,
    width: int,
    height: int,
    m_cap: int = 128,
) -> tuple[int, bool, bool, int]:
    """Host-side camera statics ``(axis, flip, swap, m)``.

    The intermediate size ``m`` tracks the volume's screen footprint
    (magnification ~1) up to ``m_cap`` (at most 512).
    """
    s2l_np = np.asarray(screen_to_local)
    eye_np = np.asarray(eye_local)
    box_px = _box_screen_px(s2l_np, width, height)
    m = int(np.clip(16 * round(0.9 * box_px / 16), 32, min(m_cap, 512)))
    axis, flip, swap = _tex_params(eye_np, s2l_np, width, height)
    return axis, flip, swap, m


def raymarch_shearwarp(
    density: torch.Tensor,
    light_vol: torch.Tensor,
    screen_to_local,
    eye_local,
    clear_color,
    width: int,
    height: int,
    m_cap: int = 128,
    ss: int = 1,
    use_kernels: bool = True,
) -> torch.Tensor:
    """Render via the shear-warp path -> [H, W, 3] f32 on the density's
    device. Picks the host statics, then marches and resolves.
    ``ss``: z-supersampling factor (the ``-hq`` high-fidelity mode)."""
    n = density.shape[0]
    s2l_np = np.asarray(screen_to_local, np.float32)
    eye_np = np.asarray(eye_local, np.float32)
    axis, flip, swap, m = shearwarp_statics(
        s2l_np, eye_np, width, height, m_cap=m_cap
    )
    return _shearwarp_core(
        density, light_vol, s2l_np, eye_np,
        np.asarray(clear_color, np.float32), n, m, width, height, axis, flip,
        swap, ss=ss, use_kernels=use_kernels,
    )
