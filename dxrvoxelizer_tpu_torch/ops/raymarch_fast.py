"""Gather volume ray-marcher: a light volume, then one march per pixel.

Port of ``dxrvoxelizer_tpu/ops/raymarch_fast.py`` (XLA functions, no Pallas
kernel there). The reference's pixel shader (PSRayCast.hlsl:117-187) is a
sequential 128-step march with a nested 32-step light march. This renderer
keeps the march and replaces the nested light march by one trilinear read
of a light volume:

1. **Light volume** (:func:`precompute_light_volume`): per voxel centre,
   the reference's 32-step light march (PSRayCast.hlsl:156-173), toward a
   directional light or, with ``point_light``, toward the light point.
2. **Gather march** (:func:`raymarch_fast`): per pixel, 128 steps at
   ``entry + dir * (s * step)``, each a trilinear density read, with the
   shader's absorption and breaks, then the tone curve.

The JAX package writes the breaks as a cumprod and masked maxima, which a
TPU runs without a sequential loop. A GPU runs the loop: each has a hand
written CUDA kernel (``csrc/light_volume.cu``, one thread per voxel in
voxel bricks; ``csrc/gather_march.cu``, one thread per pixel in screen
tiles, with the ray set-up fused in, issuing the density taps of two
steps before their break tests) and a plain version that runs the same
loop as torch ops, step by step, vectorised over voxels or pixels, with the
loop's break rules: an out-of-box step ends the march, and the first
occupied step whose transmittance falls below 0.01 ends it with that value
as the final transmittance. These give the values of JAX's masks up to the
product's rounding order. Positions are affine in the step index, as in
JAX (``pos0 + step * (j + 1)``, ``entry + dir * (s * step)``).

- :func:`light_volume` and :func:`gather_march` are the wrappers: a CUDA
  tensor launches the kernel (or raises), a CPU tensor takes the plain
  version (:func:`light_volume_plain`; :func:`gather_rays` then
  :func:`gather_march_plain`). Neither kernel copies anything from the
  host: the light step and the camera are kernel arguments.
- The plain versions' set-up is torch ops on the host or the density's
  device: :func:`light_setup` (voxel-centre table and light step),
  :func:`gather_rays` (the ray set-up), :func:`sample_offsets`. The kernels
  compute the same values themselves, rounded the same way.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from dxrvoxelizer_tpu_torch.ops import _cuda
from dxrvoxelizer_tpu_torch.ops.raymarch_ref import (
    ABSORPTION,
    MAX_DIST,
    TEX_SCALE,
    ZERO_THRESHOLD,
    _f32,
    compute_start_point,
    norm3,
    screen_rays,
)
from dxrvoxelizer_tpu_torch.ops.intersect import sqrt_rn

__all__ = ["precompute_light_volume", "raymarch_fast"]

GATHER_MARCH = _cuda.Kernel(
    name="gather_march",
    symbol="gather_march_kernel",
    source="dxrvoxelizer_tpu_torch/csrc/gather_march.cu",
    replaces="dxrvoxelizer_tpu/ops/raymarch_fast.py:160",
)
LIGHT_VOLUME = _cuda.Kernel(
    name="light_volume",
    symbol="light_volume_kernel",
    source="dxrvoxelizer_tpu_torch/csrc/light_volume.cu",
    replaces="dxrvoxelizer_tpu/ops/raymarch_fast.py:89",
)

LIGHT_CHUNK = 1 << 18  # voxels per step of the plain light volume
MAX_N = 1024  # the kernels' volumes index with 32-bit offsets (trilinear.cuh)
PX_CHUNK = 1 << 17  # pixels per step of the plain march (the JAX default)


def _check_n(n: int) -> None:
    if n > MAX_N:
        raise ValueError(f"the gather kernels take volumes up to {MAX_N}^3, "
                         f"got {n}^3")


def _flat_trilinear(vol_flat: torch.Tensor, n: int,
                    tex: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of a flattened [n^3] volume at tex in [0,1]^3.

    Linear-clamp semantics (texel centers at (i+0.5)/n); the order of
    operations of ``sampling.sample_trilinear`` and ``csrc/trilinear.cuh``.
    """
    c = tex * n - 0.5
    c0 = torch.floor(c)
    f = c - c0
    ci = c0.to(torch.int32)
    i0 = torch.clamp(ci, 0, n - 1).long()
    i1 = torch.clamp(ci + 1, 0, n - 1).long()

    def at(ix, iy, iz):
        return vol_flat[(ix * n + iy) * n + iz]

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    x1, y1, z1 = i1[..., 0], i1[..., 1], i1[..., 2]
    v000, v100 = at(x0, y0, z0), at(x1, y0, z0)
    v010, v110 = at(x0, y1, z0), at(x1, y1, z0)
    v001, v101 = at(x0, y0, z1), at(x1, y0, z1)
    v011, v111 = at(x0, y1, z1), at(x1, y1, z1)

    c00 = v000 + (v100 - v000) * fx
    c10 = v010 + (v110 - v010) * fx
    c01 = v001 + (v101 - v001) * fx
    c11 = v011 + (v111 - v011) * fx
    c0_ = c00 + (c10 - c00) * fy
    c1_ = c01 + (c11 - c01) * fy
    return c0_ + (c1_ - c0_) * fz


def _get_sample(vol_flat, n, tex):
    """GetSample (PSRayCast.hlsl:103-112): min(trilinear * 8, 16)."""
    return torch.clamp(_flat_trilinear(vol_flat, n, tex) * 8.0, max=16.0)


# ---- light volume -----------------------------------------------------------

def voxel_centres(n: int) -> torch.Tensor:
    """Voxel-centre coordinates (i + 0.5) / n * 2 - 1, [n] f32 on the host
    (pos0 is (t[x], -t[y], t[z]), JAX's ``meshgrid(t, -t, t)``)."""
    return (torch.arange(n, dtype=torch.float32) + 0.5) / n * 2.0 - 1.0


def light_vector(light_local, n_light: int = 32,
                 point_light: bool = False) -> torch.Tensor:
    """The light volume's step, [3] f32 on the host: the directional step
    ``light / |light| * MAX_DIST / n_light`` (numpy float32, each operation
    rounded once as torch's), or the light point itself for
    ``point_light``."""
    x, y, z = np.asarray(light_local, np.float32).reshape(3)
    if not point_light:
        # float32 scalars; the root of the float32 sum in float64, rounded
        # once (the correctly rounded float32 root, as sqrt_rn)
        nrm = np.float32(math.sqrt((x * x + y * y) + z * z))
        s = np.float32(MAX_DIST / n_light)
        x, y, z = x / nrm * s, y / nrm * s, z / nrm * s
    return torch.from_numpy(np.array((x, y, z), np.float32))


def light_setup(n: int, light_local, n_light: int = 32,
                point_light: bool = False):
    """The plain light volume's inputs, on the host -> (t [n], vec [3]):
    :func:`voxel_centres` and :func:`light_vector`."""
    return voxel_centres(n), light_vector(light_local, n_light, point_light)


def light_volume_plain(density: torch.Tensor, t: torch.Tensor,
                       vec: torch.Tensor, n_light: int = 32,
                       point_light: bool = False, chunk: int = LIGHT_CHUNK,
                       return_steps: bool = False):
    """Plain light volume -> [N,N,N] f32 transmittance on the density's
    device (with ``return_steps``: also the density samples taken per
    voxel, [N^3] int32). Chunks of ``chunk`` voxels, each a loop over the
    ``n_light`` steps."""
    n = density.shape[0]
    device = density.device
    lss = MAX_DIST / n_light
    vol_flat = density.reshape(-1)
    t, vec = t.to(device), vec.to(device)
    tex_scale = _f32(TEX_SCALE).to(device)
    v = n * n * n
    out = torch.empty(v, dtype=torch.float32, device=device)
    steps = torch.zeros(v, dtype=torch.int32, device=device) if return_steps else None
    for lo in range(0, v, chunk):
        idx = torch.arange(lo, min(lo + chunk, v), device=device)
        pos0 = torch.stack([t[idx // (n * n)], -t[(idx // n) % n], t[idx % n]],
                           dim=-1)
        if point_light:
            ld = vec - pos0
            step = ld / norm3(ld)[:, None] * lss
        else:
            step = vec
        trans = torch.ones(len(idx), dtype=torch.float32, device=device)
        alive = torch.ones(len(idx), dtype=torch.bool, device=device)
        for j in range(n_light):
            # the first sample is one step off (PSRayCast.hlsl:157)
            pos = pos0 + step * float(j + 1)
            alive = alive & torch.all(torch.abs(pos) <= 1.0, dim=-1)
            dens = _get_sample(vol_flat, n, tex_scale * pos + 0.5)
            att = torch.clamp(1.0 - ABSORPTION * lss * dens, 0.0, 1.0)
            trans = torch.where(alive, trans * att, trans)
            if return_steps:
                steps[lo:lo + len(idx)] += alive.to(torch.int32)
            alive = alive & (trans >= ZERO_THRESHOLD)
        out[lo:lo + len(idx)] = trans
    out = out.reshape(n, n, n)
    return (out, steps) if return_steps else out


def light_volume(density: torch.Tensor, vec: torch.Tensor, n_light: int = 32,
                 point_light: bool = False) -> torch.Tensor:
    """Light volume -> [N,N,N] f32: a CUDA tensor launches
    ``csrc/light_volume.cu``; a CPU tensor takes :func:`light_volume_plain`.
    ``vec``: from :func:`light_vector` (a host tensor, passed by value)."""
    n = density.shape[0]
    if density.device.type == "cpu":
        return light_volume_plain(density, voxel_centres(n), vec, n_light,
                                  point_light)
    _cuda.require(density, "density", torch.float32, (n, n, n))
    _check_n(n)
    if tuple(vec.shape) != (3,):
        raise ValueError(f"vec: expected (3,), got {tuple(vec.shape)}")
    vx, vy, vz = (float(x) for x in vec.tolist())
    lib = _cuda.load()
    out = torch.empty((n, n, n), dtype=torch.float32, device=density.device)
    code = lib.dxv_light_volume(density.data_ptr(), out.data_ptr(), n, n_light,
                                ctypes.c_float(MAX_DIST / n_light), vx, vy, vz,
                                int(point_light),
                                _cuda.stream_ptr(density.device))
    _cuda.check(code, LIGHT_VOLUME.name)
    LIGHT_VOLUME.launches += 1
    return out


def precompute_light_volume(density: torch.Tensor, light_local,
                            n_light: int = 32, point_light: bool = False,
                            use_kernel: bool = True) -> torch.Tensor:
    """Light transmittance at every voxel center -> [N,N,N] f32.

    The reference's light loop (PSRayCast.hlsl:156-173) from each voxel
    center: ``n_light`` steps of length 2*sqrt(3)/n_light toward the light,
    sampling the density trilinearly, with both break rules.
    ``point_light``: per-voxel direction ``normalize(lightPt - pos)`` (the
    _POINT_LIGHT_ branch, PSRayCast.hlsl:151-154). ``use_kernel=False``
    runs the plain version on any device.
    """
    vec = light_vector(light_local, n_light, point_light)
    density = density.contiguous()
    if use_kernel:
        return light_volume(density, vec, n_light, point_light)
    return light_volume_plain(density, voxel_centres(density.shape[0]), vec,
                              n_light, point_light)


# ---- gather march -----------------------------------------------------------

def gather_rays(screen_to_local, eye_local, width: int, height: int,
                y_offset: float = 0.0, device=None):
    """The march's shared ray set-up -> (entry, dir [H*W, 3] f32, hit [H*W]
    bool): the screen-to-local transform and ``compute_start_point``."""
    pos, ray_dir = screen_rays(screen_to_local, eye_local, width, height,
                               y_offset, device)
    entry, hit = compute_start_point(pos, ray_dir)
    return entry.contiguous(), ray_dir.contiguous(), hit.contiguous()


def sample_offsets(n_samples: int) -> torch.Tensor:
    """Step offsets ``s * MAX_DIST / n_samples`` on the host, [n_samples]."""
    return torch.arange(n_samples, dtype=torch.float32) * (MAX_DIST / n_samples)


def gather_march_plain(density: torch.Tensor, light_vol: torch.Tensor,
                       entry: torch.Tensor, ray_dir: torch.Tensor,
                       hit: torch.Tensor, clear_color, n_samples: int = 128,
                       px_chunk: int = PX_CHUNK, return_steps: bool = False):
    """Plain gather march -> rgb [P, 3] f32 (with ``return_steps``: also
    the density and light samples taken per pixel and the step at which
    each hit pixel's loop stopped, the first out-of-box step or the one
    whose transmittance fell below 0.01, ``n_samples`` if none: [P] int32
    each). Chunks of ``px_chunk`` pixels, each a loop over the
    ``n_samples`` steps."""
    n = density.shape[0]
    device = density.device
    step_scale = MAX_DIST / n_samples
    soff = sample_offsets(n_samples).tolist()
    dens_flat = density.reshape(-1)
    light_flat = light_vol.reshape(-1)
    tex_scale = _f32(TEX_SCALE).to(device)
    clear = _f32(clear_color).to(device)
    n_px = entry.shape[0]
    rgb = torch.empty((n_px, 3), dtype=torch.float32, device=device)
    if return_steps:
        steps_d = torch.zeros(n_px, dtype=torch.int32, device=device)
        steps_l = torch.zeros(n_px, dtype=torch.int32, device=device)
        stop = torch.zeros(n_px, dtype=torch.int32, device=device)
    for lo in range(0, n_px, px_chunk):
        hi = min(lo + px_chunk, n_px)
        e, d, alive = entry[lo:hi], ray_dir[lo:hi], hit[lo:hi]
        if return_steps:
            stop[lo:hi] = torch.where(alive, n_samples, 0)
        transmit = torch.ones(hi - lo, dtype=torch.float32, device=device)
        scatter = torch.zeros(hi - lo, dtype=torch.float32, device=device)
        for s in range(n_samples):
            pos = e + d * soff[s]
            was = alive
            alive = alive & torch.all(torch.abs(pos) <= 1.0, dim=-1)
            tex = tex_scale * pos + 0.5
            dens = _get_sample(dens_flat, n, tex)
            occupied = alive & (dens > ZERO_THRESHOLD)
            sigma = dens * step_scale
            att = torch.clamp(1.0 - sigma * ABSORPTION, 0.0, 1.0)
            transmit = torch.where(occupied, transmit * att, transmit)
            # break BEFORE scatter when transmit dies (PSRayCast.hlsl:147-148)
            died = occupied & (transmit < ZERO_THRESHOLD)
            contributes = occupied & ~died
            lt = _flat_trilinear(light_flat, n, tex)
            scatter = torch.where(contributes, scatter + lt * transmit * sigma,
                                  scatter)
            if return_steps:
                steps_d[lo:hi] += alive.to(torch.int32)
                steps_l[lo:hi] += contributes.to(torch.int32)
                stopped = (was & ~alive) | died
                stop[lo:hi] = torch.where(stopped, s, stop[lo:hi])
            alive = alive & ~died
        result = scatter[:, None] * 0.8 + 0.2
        result = result + (clear * clear - result) * transmit[:, None]
        # misses return the clear color directly (PSRayCast.hlsl:121)
        rgb[lo:hi] = torch.where(hit[lo:hi, None], sqrt_rn(result), clear)
    return (rgb, steps_d, steps_l, stop) if return_steps else rgb


def _gather_plain(density, light_vol, screen_to_local, eye_local,
                  clear_color, width, height, n_samples, y_offset, px_chunk):
    """The plain path from the camera: :func:`gather_rays` then
    :func:`gather_march_plain`."""
    rays = gather_rays(screen_to_local, eye_local, width, height, y_offset,
                       density.device)
    return gather_march_plain(density, light_vol, *rays, clear_color,
                              n_samples, px_chunk)


def _camera_args(screen_to_local, eye_local, clear_color, y_offset: float,
                n_samples: int) -> np.ndarray:
    """The gather kernel's camera, 24 host float32s: ``screen_to_local``
    (row-major), the eye, the clear colour, the band's first row and the
    step ``MAX_DIST / n_samples``, each rounded to float32 as the plain
    version's torch ops round them."""
    return np.concatenate([
        np.asarray(screen_to_local, np.float32).reshape(16),
        np.asarray(eye_local, np.float32).reshape(3),
        np.asarray(clear_color, np.float32).reshape(3),
        np.array([y_offset, MAX_DIST / n_samples], np.float32)])


def gather_march(density: torch.Tensor, light_vol: torch.Tensor,
                 screen_to_local, eye_local, clear_color, width: int,
                 height: int, n_samples: int = 128, y_offset: float = 0.0,
                 px_chunk: int = PX_CHUNK) -> torch.Tensor:
    """Gather march from the camera -> rgb [height * width, 3] f32 (rows of
    the band from screen row ``y_offset``): a CUDA tensor launches
    ``csrc/gather_march.cu``, which sets up its rays itself; a CPU tensor
    takes :func:`gather_rays` then :func:`gather_march_plain` (``px_chunk``
    is its)."""
    if density.device.type == "cpu":
        return _gather_plain(density, light_vol, screen_to_local, eye_local,
                             clear_color, width, height, n_samples, y_offset,
                             px_chunk)
    n = density.shape[0]
    _cuda.require(density, "density", torch.float32, (n, n, n))
    _cuda.require(light_vol, "light_volume", torch.float32, (n, n, n))
    _check_n(n)
    camera = _camera_args(screen_to_local, eye_local, clear_color, y_offset,
                         n_samples)
    lib = _cuda.load()
    rgb = torch.empty((width * height, 3), dtype=torch.float32,
                      device=density.device)
    code = lib.dxv_gather_march(density.data_ptr(), light_vol.data_ptr(),
                                rgb.data_ptr(), camera.ctypes.data, n, width,
                                height, n_samples,
                                _cuda.stream_ptr(density.device))
    _cuda.check(code, GATHER_MARCH.name)
    GATHER_MARCH.launches += 1
    return rgb


def raymarch_fast(
    density: torch.Tensor,
    light_vol: torch.Tensor,
    screen_to_local,
    eye_local,
    clear_color,
    width: int,
    height: int,
    n_samples: int = 128,
    px_chunk: int = PX_CHUNK,
    y_offset: float = 0.0,
    use_kernel: bool = True,
) -> torch.Tensor:
    """Render -> [height, width, 3] float32 in [0,1] on the density's device.

    ``density``: [N,N,N] alpha grid; ``light_vol``: from
    :func:`precompute_light_volume`; matrices in row-vector convention.
    ``y_offset``: first screen row (band renders). ``use_kernel=False``
    runs the plain version (:func:`gather_rays` + :func:`gather_march_plain`)
    on any device.
    """
    fn = gather_march if use_kernel else _gather_plain
    rgb = fn(density.contiguous(), light_vol.contiguous(), screen_to_local,
             eye_local, clear_color, width, height, n_samples, y_offset,
             px_chunk)
    return rgb.reshape(height, width, 3)
