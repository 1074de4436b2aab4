"""Batched ray-triangle intersection primitives (torch).

Port of ``dxrvoxelizer_tpu/ops/intersect.py``: the replacement for DXR's
fixed-function ``TraceRay`` (reference: DXRVoxelizer.hlsl:80) — a no-culling
Moller-Trumbore test and the radial form for rays through the grid origin,
each with a running closest-hit reduction over triangle chunks.

Every expression chain is SCALARIZED in the JAX package's order, e.g.
``w0 = (dx*g0x + dy*g0y) + dz*g0z``, ``den = (w0 + w1) + w2``,
``t = c/den - s0``: eager torch runs each multiply and add as its own
operation, so nothing contracts into an FMA, and the CUDA kernel
(csrc/raystab_fold.cu) spells the same chains with ``__fmul_rn``/``__fadd_rn``.
Boundary-exact hits then agree bit for bit between the oracles, the kernel's
plain version and the kernel. No chain is written as a ``sum`` or ``norm``
over the xyz axis: a reduction kernel may add in another order. Square
roots go through :func:`sqrt_rn`.
"""

from __future__ import annotations

import torch

EPS_DET = 1e-10
T_MAX = 1e4  # ray.TMax (DXRVoxelizer.hlsl:77)
BIG_ID = 2**30  # id of a miss (exactly representable in f32)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device.

    PyTorch's vectorized CPU ``sqrt`` is not always correctly rounded (it
    differs from IEEE in the last bit of some voxel-ray norms); the CUDA one
    is. A float64 root rounded once to float32 is the correctly rounded
    float32 root: 53 bits leave ample room against double rounding."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def triangle_soup(verts: torch.Tensor, tris: torch.Tensor):
    """Gather (v0, e1, e2) triangle soup from indexed buffers."""
    v0 = verts[tris[:, 0]]
    v1 = verts[tris[:, 1]]
    v2 = verts[tris[:, 2]]
    return v0, v1 - v0, v2 - v0


def mt_hit(o, d, v0, e1, e2):
    """Moller-Trumbore test, broadcasting over leading dims -> (t, u, v, hit).

    No backface culling; t >= 0 (TMin = 0, TMax = 1e4,
    DXRVoxelizer.hlsl:76-77); t = +inf on miss.
    """
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    v0x, v0y, v0z = v0[..., 0], v0[..., 1], v0[..., 2]
    e1x, e1y, e1z = e1[..., 0], e1[..., 1], e1[..., 2]
    e2x, e2y, e2z = e2[..., 0], e2[..., 1], e2[..., 2]

    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = det.abs() > EPS_DET
    inv_det = torch.where(ok, 1.0 / det, torch.zeros_like(det))
    tvx = ox - v0x
    tvy = oy - v0y
    tvz = oz - v0z
    u = (tvx * px + tvy * py + tvz * pz) * inv_det
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= 0.0) & (t <= T_MAX)
    t = torch.where(hit, t, torch.full_like(t, float("inf")))
    return t, u, v, hit


def mt_finalize(d, n0, n1, n2, u, v, hit, threshold: float, rule: str):
    """The winner's finished rgba channels from its Moller-Trumbore (u, v).

    ``d`` [R,3] the ray directions, ``n0``..``n2`` [R,3] the winner's vertex
    normals. The normal is the barycentric interpolation
    (DXRVoxelizer.hlsl:110-116), normalized, its norm and dot spelled
    ((x + y) + z); inside = hit & (nrm . d > threshold), or just hit under
    rule "hit". Returns (inside, nx, ny, nz).
    """
    nrm = n0 + u[:, None] * (n1 - n0) + v[:, None] * (n2 - n0)
    x, y, z = nrm[:, 0], nrm[:, 1], nrm[:, 2]
    ln = torch.clamp(sqrt_rn((x * x + y * y) + z * z), min=1e-20)
    nrm = nrm / ln[:, None]
    nx, ny, nz = nrm[:, 0], nrm[:, 1], nrm[:, 2]
    if rule == "hit":
        inside = hit
    else:
        inside = hit & (((nx * d[:, 0] + ny * d[:, 1]) + nz * d[:, 2]) > threshold)
    return inside, nx, ny, nz


def rgba_channels(inside, nx, ny, nz):
    """The reference's ``float4(Normal, 1.0)`` write where inside, zeros
    elsewhere -> [R,4] (DXRVoxelizer.hlsl:83-84)."""
    zero = torch.zeros_like(nx)
    return torch.stack([torch.where(inside, nx, zero),
                        torch.where(inside, ny, zero),
                        torch.where(inside, nz, zero),
                        torch.where(inside, torch.ones_like(nx), zero)], dim=-1)


def _cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def radial_setup(verts: torch.Tensor, tris: torch.Tensor):
    """Per-triangle coefficients for rays through the grid origin.

    Every voxelize ray satisfies ``origin = s0 * direction`` (generateRay,
    DXRVoxelizer.hlsl:44-53), so the hit test needs only three signed
    volumes linear in d: ``w_i = d . g_i`` with ``g0 = v1 x v2``,
    ``g1 = v2 x v0``, ``g2 = v0 x v1``; the hit parameter is
    ``s = c / (w0 + w1 + w2)`` with ``c = g0 . v0`` and t = s - s0.
    Returns (g0, g1, g2 [T,3], c [T]).
    """
    v0 = verts[tris[:, 0]]
    v1 = verts[tris[:, 1]]
    v2 = verts[tris[:, 2]]
    g0 = _cross(v1, v2)
    g1 = _cross(v2, v0)
    g2 = _cross(v0, v1)
    c = g0[..., 0] * v0[..., 0] + g0[..., 1] * v0[..., 1] + g0[..., 2] * v0[..., 2]
    return g0, g1, g2, c


def radial_hit(dx, dy, dz, s0, g0x, g0y, g0z, g1x, g1y, g1z, g2x, g2y, g2z, c):
    """Radial-ray/triangle test -> (t, hit); t = +inf on miss.

    Inclusive ``w_i >= 0`` / ``<= 0`` bounds (hits on edges and vertices
    count), as Moller-Trumbore's u >= 0, v >= 0, u + v <= 1.
    """
    w0 = dx * g0x + dy * g0y + dz * g0z
    w1 = dx * g1x + dy * g1y + dz * g1z
    w2 = dx * g2x + dy * g2y + dz * g2z
    den = (w0 + w1) + w2
    wmin = torch.minimum(w0, torch.minimum(w1, w2))
    wmax = torch.maximum(w0, torch.maximum(w1, w2))
    t = c / den - s0
    hit = (
        (den.abs() > EPS_DET)
        & ((wmin >= 0.0) | (wmax <= 0.0))
        & (t >= 0.0)
        & (t <= T_MAX)
    )
    return torch.where(hit, t, torch.full_like(t, float("inf"))), hit


def radial_finalize(dx, dy, dz, g, nv, hit, threshold: float, rule: str):
    """The winner's finished rgba channels from its radial rows.

    ``g`` = (g0x..g2z) and ``nv`` = (n0x..n2z), nine tensors each, the
    winning triangle's coefficient and vertex-normal rows. Barycentrics come
    from the radial signed volumes: ``ns = w0 n0 + w1 n1 + w2 n2``,
    ``nrm = normalize(ns / den)``; inside = hit & (nrm . d > threshold), or
    just hit under rule "hit". Returns (inside, nx, ny, nz).
    """
    w0 = dx * g[0] + dy * g[1] + dz * g[2]
    w1 = dx * g[3] + dy * g[4] + dz * g[5]
    w2 = dx * g[6] + dy * g[7] + dz * g[8]
    den = (w0 + w1) + w2
    nsx = w0 * nv[0] + w1 * nv[3] + w2 * nv[6]
    nsy = w0 * nv[1] + w1 * nv[4] + w2 * nv[7]
    nsz = w0 * nv[2] + w1 * nv[5] + w2 * nv[8]
    dn = torch.where(den == 0.0, torch.ones_like(den), den)
    nx, ny, nz = nsx / dn, nsy / dn, nsz / dn
    ss = (nx * nx + ny * ny) + nz * nz
    ln = torch.clamp(sqrt_rn(ss), min=1e-20)
    nx, ny, nz = nx / ln, ny / ln, nz / ln
    if rule == "hit":
        inside = hit
    else:
        dot = (nx * dx + ny * dy) + nz * dz
        inside = hit & (dot > threshold)
    return inside, nx, ny, nz


def radial_closest_hit(dirs, s0, g0, g1, g2, c, tri_chunk: int = 2048):
    """Radial-form closest hit over the whole soup -> (t, tri_idx).

    ``dirs`` [R,3], ``s0`` [R]; ties go to the lowest triangle index (the
    lexicographic (t, id) fold of the binned query).
    """
    r = dirs.shape[0]
    dx, dy, dz = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    s0c = s0[:, None]
    bt = torch.full((r,), float("inf"), dtype=dirs.dtype, device=dirs.device)
    bi = torch.full((r,), BIG_ID, dtype=torch.int32, device=dirs.device)
    for off in range(0, c.shape[0], tri_chunk):
        sl = slice(off, off + tri_chunk)
        cg0, cg1, cg2, cc = g0[sl], g1[sl], g2[sl], c[sl]
        t, _ = radial_hit(
            dx, dy, dz, s0c,
            cg0[None, :, 0], cg0[None, :, 1], cg0[None, :, 2],
            cg1[None, :, 0], cg1[None, :, 1], cg1[None, :, 2],
            cg2[None, :, 0], cg2[None, :, 1], cg2[None, :, 2],
            cc[None, :],
        )  # [R, Tc]
        t_min = t.min(dim=1).values
        ids = torch.arange(t.shape[1], dtype=torch.int32, device=t.device) + off
        i_min = torch.where(t == t_min[:, None], ids[None, :],
                            torch.full_like(ids, BIG_ID)[None, :]).min(dim=1).values
        closer = (t_min < bt) | ((t_min == bt) & (i_min < bi))
        bt = torch.where(closer, t_min, bt)
        bi = torch.where(closer, i_min, bi)
    return bt, bi


def closest_hit(origins, dirs, v0, e1, e2, tri_chunk: int = 2048):
    """Closest hit over the whole soup, scanning triangle chunks.

    Returns (t, u, v, tri_idx); t = +inf where the ray misses everything.
    Within a chunk the first minimum wins; across chunks only a strictly
    closer hit replaces the earlier one (ties keep the lower index).
    """
    r = origins.shape[0]
    dev = origins.device
    bt = torch.full((r,), float("inf"), dtype=origins.dtype, device=dev)
    bu = torch.zeros((r,), dtype=origins.dtype, device=dev)
    bv = torch.zeros((r,), dtype=origins.dtype, device=dev)
    bi = torch.zeros((r,), dtype=torch.int32, device=dev)
    rows = torch.arange(r, device=dev)
    for off in range(0, v0.shape[0], tri_chunk):
        sl = slice(off, off + tri_chunk)
        t, u, v, _ = mt_hit(origins[:, None, :], dirs[:, None, :],
                            v0[None, sl], e1[None, sl], e2[None, sl])
        best = torch.argmin(t, dim=1)
        tb, ub, vb = t[rows, best], u[rows, best], v[rows, best]
        take = tb < bt
        bt = torch.where(take, tb, bt)
        bu = torch.where(take, ub, bu)
        bv = torch.where(take, vb, bv)
        bi = torch.where(take, (best + off).to(torch.int32), bi)
    return bt, bu, bv, bi
