"""Shared triangle setup for the parity (axis-ray) voxelizers.

Port of ``dxrvoxelizer_tpu/ops/geom.py``. The counting oracle, the plain
binned path and the CUDA kernel consume the exact same per-triangle
quantities computed by :func:`parity_tri_setup`, in the same float32
expression order as the JAX package, op for op, so their boundary
tie-breaking agrees bit-for-bit with it.

Formulation: one axis-aligned ray per voxel column along +z in *index space*
(voxel centers at integer coordinates, see ops/packing.py). A column (x, y) is
crossed by a triangle iff its 2D projection covers the column center under a
top-left-style boundary rule; the crossing depth z is interpolated from the
triangle plane. Voxel (x, y, k) is inside iff the number of crossings with
z > k is odd.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dxrvoxelizer_tpu_torch.ops.packing import norm_to_index_space


class ParityTris(NamedTuple):
    """Per-triangle constants for the column-parity test (all [T] float32).

    Edge i has function e_i(P) = ex_i * P.x + ey_i * P.y + eo_i, positive
    inside the (orientation-normalized) triangle. ``tl_i`` is 1.0 where the
    boundary counts (top-left-style rule), 0.0 otherwise. ``z*`` interpolates
    the crossing depth: z(P) = (zx * P.x + zy * P.y + zo).
    ``valid`` is 0.0 for degenerate (z-parallel / zero-area) projections.
    """

    ex0: torch.Tensor; ey0: torch.Tensor; eo0: torch.Tensor; tl0: torch.Tensor
    ex1: torch.Tensor; ey1: torch.Tensor; eo1: torch.Tensor; tl1: torch.Tensor
    ex2: torch.Tensor; ey2: torch.Tensor; eo2: torch.Tensor; tl2: torch.Tensor
    zx: torch.Tensor; zy: torch.Tensor; zo: torch.Tensor
    valid: torch.Tensor
    # conservative 2D bounds in index space (for binning / culling)
    xmin: torch.Tensor; xmax: torch.Tensor
    ymin: torch.Tensor; ymax: torch.Tensor


def _edge(px, py, qx, qy):
    """Edge function coefficients for edge p->q: e(P) = cross2(q-p, P-p).

    e(P) = (-dy)*P.x + dx*P.y + (dy*p.x - dx*p.y), positive to the left of
    the directed edge (CCW interior).
    """
    dx = qx - px
    dy = qy - py
    ex = -dy
    ey = dx
    eo = dy * px - dx * py
    # boundary-inclusion rule: exactly one of a shared edge's two directions
    # qualifies -> shared edges are counted exactly once.
    tl = ((dy > 0) | ((dy == 0) & (dx < 0))).to(torch.float32)
    return ex, ey, eo, tl


def parity_tri_setup(verts_norm: torch.Tensor, tris: torch.Tensor,
                     n: int) -> ParityTris:
    """Build :class:`ParityTris` from normalized-space vertices [-1,1]^3."""
    g = norm_to_index_space(verts_norm, n)
    a = g[tris[:, 0]]
    b = g[tris[:, 1]]
    c = g[tris[:, 2]]

    area2 = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (b[:, 1] - a[:, 1]) * (
        c[:, 0] - a[:, 0]
    )
    # orientation-normalize: flip b<->c where the projected winding is negative
    flip = area2 < 0
    bx = torch.where(flip, c[:, 0], b[:, 0]); by = torch.where(flip, c[:, 1], b[:, 1])
    bz = torch.where(flip, c[:, 2], b[:, 2])
    cx = torch.where(flip, b[:, 0], c[:, 0]); cy = torch.where(flip, b[:, 1], c[:, 1])
    cz = torch.where(flip, b[:, 2], c[:, 2])
    ax, ay, az = a[:, 0], a[:, 1], a[:, 2]
    abs_area2 = torch.abs(area2)
    valid = (abs_area2 > 0).to(torch.float32)

    ex0, ey0, eo0, tl0 = _edge(ax, ay, bx, by)
    ex1, ey1, eo1, tl1 = _edge(bx, by, cx, cy)
    ex2, ey2, eo2, tl2 = _edge(cx, cy, ax, ay)

    # Plane through the 3 index-space points: z(P) barycentric-interpolated,
    # expanded into affine coefficients (2 multiply-adds per column).
    inv = torch.where(abs_area2 > 0, 1.0 / abs_area2, torch.zeros_like(abs_area2))
    zx = (ex1 * az + ex2 * bz + ex0 * cz) * inv
    zy = (ey1 * az + ey2 * bz + ey0 * cz) * inv
    zo = (eo1 * az + eo2 * bz + eo0 * cz) * inv

    xmin = torch.minimum(ax, torch.minimum(bx, cx))
    xmax = torch.maximum(ax, torch.maximum(bx, cx))
    ymin = torch.minimum(ay, torch.minimum(by, cy))
    ymax = torch.maximum(ay, torch.maximum(by, cy))

    return ParityTris(
        ex0, ey0, eo0, tl0,
        ex1, ey1, eo1, tl1,
        ex2, ey2, eo2, tl2,
        zx, zy, zo, valid,
        xmin, xmax, ymin, ymax,
    )


def column_crossing(pt: ParityTris, px: torch.Tensor, py: torch.Tensor):
    """Evaluate crossing for columns broadcast against triangles.

    ``px``/``py``: column-center coordinates (integers as float32), shapes
    broadcastable against the [T] triangle axis. Returns (covered, m) where
    ``covered`` is boolean and ``m`` = int32 cutoff ``ceil(z)``: the crossing
    flips the parity of voxels k < m (clip to the caller's range).
    """
    e0 = pt.ex0 * px + pt.ey0 * py + pt.eo0
    e1 = pt.ex1 * px + pt.ey1 * py + pt.eo1
    e2 = pt.ex2 * px + pt.ey2 * py + pt.eo2
    in0 = (e0 > 0) | ((e0 == 0) & (pt.tl0 > 0))
    in1 = (e1 > 0) | ((e1 == 0) & (pt.tl1 > 0))
    in2 = (e2 > 0) | ((e2 == 0) & (pt.tl2 > 0))
    covered = in0 & in1 & in2 & (pt.valid > 0)
    z = pt.zx * px + pt.zy * py + pt.zo
    m = torch.ceil(z).to(torch.int32)
    return covered, m
