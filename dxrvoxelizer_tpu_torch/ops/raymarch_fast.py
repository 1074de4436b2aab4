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
written CUDA kernel (``csrc/light_volume.cu``, ``csrc/gather_march.cu``,
one thread per voxel or pixel) and a plain version that runs the same
loop as torch ops, step by step, vectorised over voxels or pixels, with the
loop's break rules: an out-of-box step ends the march, and the first
occupied step whose transmittance falls below 0.01 ends it with that value
as the final transmittance. These give the values of JAX's masks up to the
product's rounding order. Positions are affine in the step index, as in
JAX (``pos0 + step * (j + 1)``, ``entry + dir * (s * step)``).

- :func:`light_volume` and :func:`gather_march` are the wrappers: a CUDA
  tensor launches the kernel (or raises), a CPU tensor takes the plain
  version (:func:`light_volume_plain`, :func:`gather_march_plain`).
- The set-up both versions share (voxel-centre table, light step, the ray
  set-up and step offsets) is torch ops: :func:`light_setup`,
  :func:`gather_rays`, :func:`sample_offsets`.
"""

from __future__ import annotations

import ctypes

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
PX_CHUNK = 1 << 17  # pixels per step of the plain march (the JAX default)


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

def light_setup(n: int, light_local, n_light: int = 32,
                point_light: bool = False):
    """The light volume's shared inputs, on the host -> (t [n], vec [3]).

    ``t``: voxel-centre coordinates ((i + 0.5) / n * 2 - 1; pos0 is
    (t[x], -t[y], t[z]), JAX's ``meshgrid(t, -t, t)``). ``vec``: the
    directional step ``light / |light| * MAX_DIST / n_light``, or the light
    point itself for ``point_light``.
    """
    t = (torch.arange(n, dtype=torch.float32) + 0.5) / n * 2.0 - 1.0
    light = _f32(light_local)
    if point_light:
        return t, light
    return t, light / norm3(light) * (MAX_DIST / n_light)


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


def light_volume(density: torch.Tensor, t: torch.Tensor, vec: torch.Tensor,
                 n_light: int = 32, point_light: bool = False) -> torch.Tensor:
    """Light volume -> [N,N,N] f32: a CUDA tensor launches
    ``csrc/light_volume.cu``; a CPU tensor takes :func:`light_volume_plain`.
    ``t``, ``vec``: from :func:`light_setup` (host tensors)."""
    if density.device.type == "cpu":
        return light_volume_plain(density, t, vec, n_light, point_light)
    n = density.shape[0]
    _cuda.require(density, "density", torch.float32, (n, n, n))
    if tuple(t.shape) != (n,) or tuple(vec.shape) != (3,):
        raise ValueError(f"t: expected ({n},), vec (3,): got "
                         f"{tuple(t.shape)}, {tuple(vec.shape)}")
    t_d = t.to(device=density.device, dtype=torch.float32).contiguous()
    vx, vy, vz = (float(x) for x in vec.tolist())
    lib = _cuda.load()
    out = torch.empty((n, n, n), dtype=torch.float32, device=density.device)
    code = lib.dxv_light_volume(
        density.data_ptr(), t_d.data_ptr(), out.data_ptr(), n, n_light,
        ctypes.c_float(MAX_DIST / n_light), vx, vy, vz, int(point_light),
        _cuda.stream_ptr(density.device),
    )
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
    t, vec = light_setup(density.shape[0], light_local, n_light, point_light)
    fn = light_volume if use_kernel else light_volume_plain
    return fn(density.contiguous(), t, vec, n_light, point_light)


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
    the density and light samples taken per pixel, [P] int32 each).
    Chunks of ``px_chunk`` pixels, each a loop over the ``n_samples``
    steps."""
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
    for lo in range(0, n_px, px_chunk):
        hi = min(lo + px_chunk, n_px)
        e, d, alive = entry[lo:hi], ray_dir[lo:hi], hit[lo:hi]
        transmit = torch.ones(hi - lo, dtype=torch.float32, device=device)
        scatter = torch.zeros(hi - lo, dtype=torch.float32, device=device)
        for s in range(n_samples):
            pos = e + d * soff[s]
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
            alive = alive & ~died
        result = scatter[:, None] * 0.8 + 0.2
        result = result + (clear * clear - result) * transmit[:, None]
        # misses return the clear color directly (PSRayCast.hlsl:121)
        rgb[lo:hi] = torch.where(hit[lo:hi, None], sqrt_rn(result), clear)
    return (rgb, steps_d, steps_l) if return_steps else rgb


def gather_march(density: torch.Tensor, light_vol: torch.Tensor,
                 entry: torch.Tensor, ray_dir: torch.Tensor, hit: torch.Tensor,
                 clear_color, n_samples: int = 128,
                 px_chunk: int = PX_CHUNK) -> torch.Tensor:
    """Gather march -> rgb [P, 3] f32: a CUDA tensor launches
    ``csrc/gather_march.cu`` (one thread per pixel; ``px_chunk`` is the
    plain version's); a CPU tensor takes :func:`gather_march_plain`."""
    if density.device.type == "cpu":
        return gather_march_plain(density, light_vol, entry, ray_dir, hit,
                                  clear_color, n_samples, px_chunk)
    n = density.shape[0]
    n_px = entry.shape[0]
    _cuda.require(density, "density", torch.float32, (n, n, n))
    _cuda.require(light_vol, "light_volume", torch.float32, (n, n, n))
    _cuda.require(entry, "entry", torch.float32, (n_px, 3))
    _cuda.require(ray_dir, "dir", torch.float32, (n_px, 3))
    _cuda.require(hit, "hit", torch.bool, (n_px,))
    soff = sample_offsets(n_samples).to(density.device)
    cr, cg, cb = (float(c) for c in np.asarray(clear_color, np.float32))
    lib = _cuda.load()
    rgb = torch.empty((n_px, 3), dtype=torch.float32, device=density.device)
    code = lib.dxv_gather_march(
        density.data_ptr(), light_vol.data_ptr(), entry.data_ptr(),
        ray_dir.data_ptr(), hit.data_ptr(), soff.data_ptr(), rgb.data_ptr(),
        n, n_px, n_samples, ctypes.c_float(MAX_DIST / n_samples), cr, cg, cb,
        _cuda.stream_ptr(density.device),
    )
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
    runs the plain version on any device.
    """
    entry, ray_dir, hit = gather_rays(screen_to_local, eye_local, width,
                                      height, y_offset, density.device)
    fn = gather_march if use_kernel else gather_march_plain
    rgb = fn(density.contiguous(), light_vol.contiguous(), entry, ray_dir, hit,
             clear_color, n_samples, px_chunk)
    return rgb.reshape(height, width, 3)
