"""Reference volume ray-marcher, shader-exact (torch ops).

Port of ``dxrvoxelizer_tpu/ops/raymarch_ref.py``: ``PSRayCast.hlsl`` step by
step (reference: Content/Shaders/PSRayCast.hlsl:117-187): screen -> local
near-plane point, ray-box entry clamp, 128 fixed primary steps with
early-out, per-occupied-sample 32-step light march, absorption-only
transmittance, final ``sqrt(scatter*0.8 + 0.2)`` tone curve lerped to the
clear color by transmittance. "Breaks" become masks: a broken lane keeps
marching but contributes nothing, so results equal the sequential shader's.
Positions accumulate (``pos = pos + step``), as in the JAX package.

This is the correctness oracle (a Python loop per step, not a product
path); the shear-warp and gather renderers are held against it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from dxrvoxelizer_tpu_torch.ops.intersect import sqrt_rn
from dxrvoxelizer_tpu_torch.ops.sampling import sample_trilinear

NUM_SAMPLES = 128  # PSRayCast.hlsl:7
NUM_LIGHT_SAMPLES = 32  # PSRayCast.hlsl:8
ABSORPTION = 1.0  # PSRayCast.hlsl:9
ZERO_THRESHOLD = 0.01  # PSRayCast.hlsl:10
MAX_DIST = 2.0 * math.sqrt(3.0)  # PSRayCast.hlsl:33
TEX_SCALE = np.array([0.5, -0.5, 0.5], dtype=np.float32)  # PSRayCast.hlsl:137
FLT_MAX = 3.402823466e38


def _f32(x, device=None) -> torch.Tensor:
    """A float32 tensor of ``x`` on ``device`` (the host by default)."""
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def norm3(v: torch.Tensor) -> torch.Tensor:
    """|v| over the last axis of size 3, as ((x*x + y*y) + z*z) with a
    correctly rounded root: the JAX package's ``jnp.linalg.norm`` on these
    vectors, and the same bits on every device and in the kernels."""
    return sqrt_rn(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                   + v[..., 2] * v[..., 2])


def get_sample(density: torch.Tensor, tex: torch.Tensor) -> torch.Tensor:
    """GetSample (PSRayCast.hlsl:103-112): min(trilinear(alpha) * 8, 16)."""
    return torch.clamp(sample_trilinear(density, tex) * 8.0, max=16.0)


def screen_rays(screen_to_local, eye_local, width: int, height: int,
                y_offset: float = 0.0, device=None):
    """Per-pixel near-plane point and unit direction, [H*W, 3] each, rows
    first (PSRayCast.hlsl:61-66, 117-119): SV_POSITION pixel centers through
    the row-vector ``screen_to_local``, starting at screen row ``y_offset``
    (band renders)."""
    sx = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    sy = torch.arange(height, dtype=torch.float32, device=device) + 0.5 + y_offset
    py, px = torch.meshgrid(sy, sx, indexing="ij")  # [H, W]
    screen = torch.stack(
        [px, py, torch.zeros_like(px), torch.ones_like(px)], dim=-1
    ).reshape(-1, 4)
    # the row-vector transform as a sum in row order, one rounding per
    # operation (the JAX package's float32 dot; no FMA, on every device)
    m = _f32(screen_to_local, device)
    h = screen[:, 0:1] * m[0]
    for k in range(1, 4):
        h = h + screen[:, k:k + 1] * m[k]
    pos = h[:, :3] / h[:, 3:4]  # ScreenToLocal
    d = pos - _f32(eye_local, device)
    ray_dir = d / norm3(d)[:, None]
    return pos, ray_dir


def compute_start_point(pos: torch.Tensor, ray_dir: torch.Tensor):
    """ComputeStartPoint (PSRayCast.hlsl:71-98), vectorized over rays.

    Returns (clamped entry pos, is_hit). Points already inside [-1,1]^3 are
    hits with unchanged pos.
    """
    inside = torch.all(torch.abs(pos) <= 1.0, dim=-1)
    big = torch.tensor(FLT_MAX, dtype=pos.dtype, device=pos.device)
    one = torch.ones((), dtype=pos.dtype, device=pos.device)
    u_best = big.expand(pos.shape[:-1])
    hit = torch.zeros(pos.shape[:-1], dtype=torch.bool, device=pos.device)
    for i in range(3):
        j, k = (i + 1) % 3, (i + 2) % 3
        di = ray_dir[..., i]
        nz = di != 0.0
        # -sign(d) target plane; d == 0 -> no crossing
        u = torch.where(nz, (-torch.sign(di) - pos[..., i])
                        / torch.where(nz, di, one), big)
        ok = ((u >= 0.0)
              & (torch.abs(ray_dir[..., j] * u + pos[..., j]) <= 1.0)
              & (torch.abs(ray_dir[..., k] * u + pos[..., k]) <= 1.0)
              & (u < u_best))
        u_best = torch.where(ok, u, u_best)
        hit = hit | ok
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
    u_final = torch.where(inside, zero, torch.where(hit, u_best, zero))
    entry = torch.clamp(ray_dir * u_final[..., None] + pos, -1.0, 1.0)
    entry = torch.where(inside[..., None], pos, entry)
    return entry, inside | hit


def _light_march(density, pos, light_step, n_light: int) -> torch.Tensor:
    """Inner light loop (PSRayCast.hlsl:156-173) -> lightTrans per ray."""
    light_step_scale = MAX_DIST / n_light
    light_trans = torch.ones(pos.shape[:-1], dtype=pos.dtype, device=pos.device)
    light_pos = pos + light_step
    alive = torch.ones(pos.shape[:-1], dtype=torch.bool, device=pos.device)
    tex_scale = _f32(TEX_SCALE, pos.device)
    for _ in range(n_light):
        in_box = torch.all(torch.abs(light_pos) <= 1.0, dim=-1)
        active = alive & in_box
        dens = get_sample(density, tex_scale * light_pos + 0.5)
        new_trans = light_trans * torch.clamp(
            1.0 - ABSORPTION * light_step_scale * dens, 0.0, 1.0)
        light_trans = torch.where(active, new_trans, light_trans)
        # break if transmittance died (skips future steps only)
        alive = active & (light_trans >= ZERO_THRESHOLD)
        light_pos = light_pos + light_step
    return light_trans


def raymarch_ref(
    density: torch.Tensor,
    screen_to_local,
    eye_local,
    light_local,
    clear_color,
    width: int,
    height: int,
    n_samples: int = NUM_SAMPLES,
    n_light: int = NUM_LIGHT_SAMPLES,
    y_offset: float = 0.0,
    point_light: bool = False,
) -> torch.Tensor:
    """Render the density grid -> [height, width, 3] float32 image in [0,1]
    on the density's device.

    ``density``: [N,N,N] alpha grid (post R10G10B10A2 quantization);
    ``screen_to_local``: [4,4] row-vector matrix; ``clear_color``: [3].
    ``y_offset``: first screen row (band renders). ``point_light``: the
    reference's _POINT_LIGHT_ branch, the per-sample light direction
    ``normalize(lightPt - pos)`` instead of the fixed directional step
    (PSRayCast.hlsl:125-127 vs 151-154).
    """
    device = density.device
    step_scale = MAX_DIST / n_samples
    light_step_scale = MAX_DIST / n_light
    pos, ray_dir = screen_rays(screen_to_local, eye_local, width, height,
                               y_offset, device)
    entry, is_hit = compute_start_point(pos, ray_dir)

    step = ray_dir * step_scale
    light = _f32(light_local, device)
    light_step = light / norm3(light) * light_step_scale
    tex_scale = _f32(TEX_SCALE, device)
    zero = torch.zeros((), dtype=torch.float32, device=device)

    pos = entry
    transmit = torch.ones(pos.shape[:-1], dtype=torch.float32, device=device)
    scatter = torch.zeros(pos.shape[:-1], dtype=torch.float32, device=device)
    alive = is_hit
    for _ in range(n_samples):
        in_box = torch.all(torch.abs(pos) <= 1.0, dim=-1)
        active = alive & in_box
        dens = get_sample(density, tex_scale * pos + 0.5)
        occupied = active & (dens > ZERO_THRESHOLD)

        scaled_dens = dens * step_scale
        new_transmit = transmit * torch.clamp(
            1.0 - scaled_dens * ABSORPTION, 0.0, 1.0)
        transmit = torch.where(occupied, new_transmit, transmit)
        # the shader breaks BEFORE accumulating scatter when transmit dies
        # (PSRayCast.hlsl:147-148)
        contributes = occupied & (transmit >= ZERO_THRESHOLD)
        if point_light:
            # per-sample light direction (PSRayCast.hlsl:151-154)
            ld = light - pos
            step_l = ld / norm3(ld)[:, None] * light_step_scale
        else:
            step_l = light_step
        light_trans = _light_march(density, pos, step_l, n_light)
        scatter = scatter + torch.where(
            contributes, light_trans * transmit * scaled_dens, zero)
        alive = torch.where(occupied, contributes, active)
        pos = pos + step

    clear = _f32(clear_color, device)
    result = scatter[:, None] * 0.8 + 0.2
    result = result + (clear * clear - result) * transmit[:, None]
    rgb = sqrt_rn(result)
    # misses return the clear color directly (PSRayCast.hlsl:121)
    out = torch.where(is_hit[:, None], rgb, clear)
    return out.reshape(height, width, 3)
