"""Scene state: mesh + placement + per-frame shader constants.

Mirrors the state the reference keeps in ``Voxelizer`` and uploads per frame in
``UpdateFrame`` (reference: Content/Voxelizer.cpp:81-106, Voxelizer.h:71-76):
``localSpaceLightPt``, ``localSpaceEyePt`` and the ``screenToLocal`` matrix.
"Local" in the shader is normalized grid space [-1,1]^3 composed with the
world transform. Frame constants stay host-side numpy (a few 4x4 ops).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dxrvoxelizer_tpu_torch.models.mesh import MeshBuffers
from dxrvoxelizer_tpu_torch.utils import dxmath as dxm
from dxrvoxelizer_tpu_torch.utils.assets import find_asset
from dxrvoxelizer_tpu_torch.utils.config import VoxelizerConfig
from dxrvoxelizer_tpu_torch.utils.device import config_device, select_device
from dxrvoxelizer_tpu_torch.utils.objloader import ObjMesh, load_obj


@dataclass
class FrameConstants:
    """Per-frame constants consumed by the ray-march pass (CBPerObject analog)."""

    local_space_light_pt: np.ndarray  # [3] f32
    local_space_eye_pt: np.ndarray  # [3] f32
    screen_to_local: np.ndarray  # [4,4] f32 (row-vector convention)


class Scene:
    """A loaded mesh plus its placement; produces per-frame constants.

    The JAX package's signature; ``device`` (keyword) places the mesh
    buffers, by default on the CUDA device. A ``str`` or ``torch.device`` in
    the second position is taken as the device (``Scene(mesh, "cpu")``)."""

    def __init__(self, mesh: ObjMesh, pos_scale=(0.0, 0.0, 0.0, 1.0),
                 light_pt=(-10.0, 45.0, -75.0), *,
                 device: torch.device | str | None = None):
        if isinstance(pos_scale, (str, torch.device)):
            if device is not None:
                raise TypeError("Scene: device given twice")
            pos_scale, device = (0.0, 0.0, 0.0, 1.0), pos_scale
        self.obj = mesh
        self.pos_scale = np.asarray(pos_scale, dtype=np.float32)
        self.light_pt = np.asarray(light_pt, dtype=np.float32)
        self.bound = mesh.bound()  # (cx, cy, cz, half_extent), Voxelizer.cpp:51-57
        device = select_device() if device is None else device
        self.buffers = MeshBuffers.from_obj(mesh, device, self.bound)

    @classmethod
    def load(cls, cfg: VoxelizerConfig,
             device: torch.device | str | None = None) -> "Scene":
        """``device``: by default the configuration's, as the app picks it
        (the CPU for ``-warp``/``-cpu``, else the CUDA device)."""
        mesh = load_obj(find_asset(cfg.mesh))
        if cfg.subdiv > 0:
            from dxrvoxelizer_tpu_torch.utils.objloader import subdivide

            mesh = subdivide(mesh, cfg.subdiv)
        return cls(mesh, pos_scale=cfg.pos_scale, light_pt=cfg.light_pt,
                   device=config_device(cfg) if device is None else device)

    def world(self) -> np.ndarray:
        return dxm.world_matrix(self.bound, self.pos_scale)

    def update_frame(self, eye_pt: np.ndarray, view_proj: np.ndarray,
                     width: int, height: int) -> FrameConstants:
        """Per-frame constants (reference: Content/Voxelizer.cpp:81-106)."""
        world = self.world()
        world_inv = dxm.inverse(world)
        return FrameConstants(
            local_space_light_pt=dxm.transform_coord(self.light_pt, world_inv),
            local_space_eye_pt=dxm.transform_coord(eye_pt, world_inv),
            screen_to_local=dxm.screen_to_local(world, view_proj, width, height),
        )
