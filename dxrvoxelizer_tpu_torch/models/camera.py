"""Orbit camera with the reference's exact conventions.

Reference: DXRVoxelizer/DXRVoxelizer.cpp:220-236 (init), 301-356 (orbit/zoom).
Left-handed look-at view, FOV pi/4, zNear 1, zFar 1000, default eye
(8, 12, -14) focused on (0, 4, 0), Y-up.
"""

from __future__ import annotations

import numpy as np

from dxrvoxelizer_tpu_torch.utils import dxmath as dxm

FOV_ANGLE_Y = np.pi / 4.0  # g_FOVAngleY (DXRVoxelizer.cpp:21)
Z_NEAR = 1.0  # DXRVoxelizer.cpp:22
Z_FAR = 1000.0  # DXRVoxelizer.cpp:23
DEFAULT_EYE = (8.0, 12.0, -14.0)  # DXRVoxelizer.cpp:231
DEFAULT_FOCUS = (0.0, 4.0, 0.0)  # DXRVoxelizer.cpp:230


class OrbitCamera:
    """Stateful orbit/zoom camera, mutated by mouse-style interactions."""

    def __init__(self, width: int, height: int,
                 eye=DEFAULT_EYE, focus=DEFAULT_FOCUS):
        self.width = int(width)
        self.height = int(height)
        self.focus = np.asarray(focus, dtype=np.float32)
        self.eye = np.asarray(eye, dtype=np.float32)
        aspect = self.width / float(self.height)
        self.proj = dxm.perspective_fov_lh(FOV_ANGLE_Y, aspect, Z_NEAR, Z_FAR)
        self.view = dxm.look_at_lh(self.eye, self.focus)

    @property
    def view_proj(self) -> np.ndarray:
        return self.view @ self.proj

    def _apply_view_transform(self, transform: np.ndarray) -> None:
        """view' = view * transform; eye = row 3 of inverse(view')
        (reference: DXRVoxelizer.cpp:325-331, 348-352)."""
        view = self.view @ transform
        view_inv = dxm.inverse(view)
        self.eye = view_inv[3, :3].copy()
        self.view = view

    def orbit(self, dx_pixels: float, dy_pixels: float) -> None:
        """Mouse-drag orbit (reference: OnMouseMove, DXRVoxelizer.cpp:314-336).

        ``dx_pixels``/``dy_pixels`` = previous mouse position minus current.
        """
        rad_x = 2.0 * np.pi * dy_pixels / self.height
        rad_y = 2.0 * np.pi * dx_pixels / self.width
        length = float(np.linalg.norm(self.focus - self.eye))
        transform = (
            dxm.translation(0.0, 0.0, -length)
            @ dxm.rotation_roll_pitch_yaw(rad_x, rad_y, 0.0)
            @ dxm.translation(0.0, 0.0, length)
        )
        self._apply_view_transform(transform)

    def zoom(self, delta_z: float) -> None:
        """Mouse-wheel dolly (reference: OnMouseWheel, DXRVoxelizer.cpp:338-353)."""
        length = float(np.linalg.norm(self.focus - self.eye))
        self._apply_view_transform(
            dxm.translation(0.0, 0.0, -length * delta_z / 16.0)
        )
