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
from dxrvoxelizer_tpu_torch.utils.objloader import ObjMesh, load_obj


@dataclass
class FrameConstants:
    """Per-frame constants consumed by the ray-march pass (CBPerObject analog)."""

    local_space_light_pt: np.ndarray  # [3] f32
    local_space_eye_pt: np.ndarray  # [3] f32
    screen_to_local: np.ndarray  # [4,4] f32 (row-vector convention)


class Scene:
    """A loaded mesh plus its placement; produces per-frame constants."""

    def __init__(self, mesh: ObjMesh, device: torch.device | str,
                 pos_scale=(0.0, 0.0, 0.0, 1.0),
                 light_pt=(-10.0, 45.0, -75.0)):
        self.obj = mesh
        self.pos_scale = np.asarray(pos_scale, dtype=np.float32)
        self.light_pt = np.asarray(light_pt, dtype=np.float32)
        self.bound = mesh.bound()  # (cx, cy, cz, half_extent), Voxelizer.cpp:51-57
        self.buffers = MeshBuffers.from_obj(mesh, device, self.bound)

    @classmethod
    def load(cls, cfg: VoxelizerConfig, device: torch.device | str) -> "Scene":
        mesh = load_obj(find_asset(cfg.mesh))
        if cfg.subdiv > 0:
            from dxrvoxelizer_tpu_torch.utils.objloader import subdivide

            mesh = subdivide(mesh, cfg.subdiv)
        return cls(mesh, device, pos_scale=cfg.pos_scale, light_pt=cfg.light_pt)

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
