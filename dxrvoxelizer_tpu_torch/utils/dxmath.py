"""DirectXMath-convention matrix math (row-vector, left-handed), float32 NumPy.

The reference drives all camera / object transforms through DirectXMath
(reference: DXRVoxelizer/DXRVoxelizer.cpp:220-236, Content/Voxelizer.cpp:81-106).
DirectXMath composes with ROW vectors: ``v' = v @ M`` and ``A * B`` applies A
first. We keep that convention exactly so transform chains can be ported and
verified term-for-term; everything here is host-side NumPy (camera math is a
few 4x4 ops per frame — not device work).
"""

from __future__ import annotations

import numpy as np

F32 = np.float32


def _m(rows) -> np.ndarray:
    return np.array(rows, dtype=F32)


def identity() -> np.ndarray:
    return np.eye(4, dtype=F32)


def translation(x: float, y: float, z: float) -> np.ndarray:
    """XMMatrixTranslation — row 3 carries the offset (row-vector convention)."""
    m = np.eye(4, dtype=F32)
    m[3, 0] = x
    m[3, 1] = y
    m[3, 2] = z
    return m


def scaling(sx: float, sy: float | None = None, sz: float | None = None) -> np.ndarray:
    """XMMatrixScaling."""
    sy = sx if sy is None else sy
    sz = sx if sz is None else sz
    return _m([[sx, 0, 0, 0], [0, sy, 0, 0], [0, 0, sz, 0], [0, 0, 0, 1]])


def look_at_lh(eye, focus, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """XMMatrixLookAtLH (left-handed view matrix, row-vector convention)."""
    eye = np.asarray(eye, dtype=F32)
    focus = np.asarray(focus, dtype=F32)
    up = np.asarray(up, dtype=F32)
    z = focus - eye
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return _m(
        [
            [x[0], y[0], z[0], 0.0],
            [x[1], y[1], z[1], 0.0],
            [x[2], y[2], z[2], 0.0],
            [-np.dot(x, eye), -np.dot(y, eye), -np.dot(z, eye), 1.0],
        ]
    )


def perspective_fov_lh(fov_y: float, aspect: float, z_near: float, z_far: float) -> np.ndarray:
    """XMMatrixPerspectiveFovLH."""
    h = 1.0 / np.tan(fov_y * 0.5)
    w = h / aspect
    q = z_far / (z_far - z_near)
    return _m(
        [
            [w, 0, 0, 0],
            [0, h, 0, 0],
            [0, 0, q, 1],
            [0, 0, -z_near * q, 0],
        ]
    )


def rotation_roll_pitch_yaw(pitch: float, yaw: float, roll: float) -> np.ndarray:
    """XMMatrixRotationRollPitchYaw — intrinsic order roll(Z), pitch(X), yaw(Y);
    composed (row-vector) as Rz * Rx * Ry."""
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    cr, sr = np.cos(roll), np.sin(roll)
    rx = _m([[1, 0, 0, 0], [0, cp, sp, 0], [0, -sp, cp, 0], [0, 0, 0, 1]])
    ry = _m([[cy, 0, -sy, 0], [0, 1, 0, 0], [sy, 0, cy, 0], [0, 0, 0, 1]])
    rz = _m([[cr, sr, 0, 0], [-sr, cr, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    return rz @ rx @ ry


def transform_coord(v, m: np.ndarray) -> np.ndarray:
    """XMVector3TransformCoord — row-vector homogeneous transform + w-divide."""
    v = np.asarray(v, dtype=F32)
    h = np.concatenate([v, np.ones(1, dtype=F32)]) @ m
    return (h[:3] / h[3]).astype(F32)


def inverse(m: np.ndarray) -> np.ndarray:
    return np.linalg.inv(m.astype(np.float64)).astype(F32)


def to_screen_matrix(width: float, height: float) -> np.ndarray:
    """NDC -> screen-pixel matrix (reference: Content/Voxelizer.cpp:96-102)."""
    return _m(
        [
            [0.5 * width, 0, 0, 0],
            [0, -0.5 * height, 0, 0],
            [0, 0, 1, 0],
            [0.5 * width, 0.5 * height, 0, 1],
        ]
    )


def world_matrix(bound: np.ndarray, pos_scale: np.ndarray) -> np.ndarray:
    """Object world matrix (reference: Content/Voxelizer.cpp:84-87).

    ``bound`` = (cx, cy, cz, half_extent) from the mesh AABB;
    ``pos_scale`` = (x, y, z, scale) from the CLI.
    world = S(bound.w) * T(bound.xyz) * S(posScale.w) * T(posScale.xyz),
    mapping normalized [-1,1]^3 grid space into world space.
    """
    b = np.asarray(bound, dtype=F32)
    p = np.asarray(pos_scale, dtype=F32)
    return (
        scaling(float(b[3]))
        @ translation(float(b[0]), float(b[1]), float(b[2]))
        @ scaling(float(p[3]))
        @ translation(float(p[0]), float(p[1]), float(p[2]))
    )


def normalized_to_local(bound: np.ndarray) -> np.ndarray:
    """S(bound.w) * T(bound.xyz) (reference: Content/Voxelizer.cpp:305)."""
    b = np.asarray(bound, dtype=F32)
    return scaling(float(b[3])) @ translation(float(b[0]), float(b[1]), float(b[2]))


def screen_to_local(world: np.ndarray, view_proj: np.ndarray,
                    width: float, height: float) -> np.ndarray:
    """inv(world * viewProj * toScreen) (reference: Content/Voxelizer.cpp:96-105).

    The reference stores the transpose into the cbuffer because HLSL defaults
    to column-major packing; with our consistent row-vector convention the
    transpose is a storage detail and is omitted — use
    ``transform_coord(screen_pos, screen_to_local(...))``.
    """
    local_to_screen = world @ view_proj @ to_screen_matrix(width, height)
    return inverse(local_to_screen)
