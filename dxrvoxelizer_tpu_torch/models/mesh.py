"""Device-resident mesh buffers.

The reference uploads interleaved VB/IB to GPU memory and builds a DXR
BLAS over them in *normalized grid space* via the instance transform
``inverse(S(bound.w) * T(bound.xyz))`` (reference: Content/Voxelizer.cpp:115-138,
304-310). Here the mesh arrays are torch tensors on a chosen device, and the
"acceleration structure" input is the pre-transformed normalized-space
triangle soup.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dxrvoxelizer_tpu_torch.utils.objloader import ObjMesh


@dataclass
class MeshBuffers:
    """Device mesh: ``positions``/``normals`` [V,3] f32, ``tris`` [T,3] int64.

    ``positions_norm`` are positions mapped to normalized grid space [-1,1]^3
    (the space in which the reference's acceleration structure lives).
    ``tris`` is int64, torch's index type (the JAX package keeps int32).
    """

    positions: torch.Tensor
    normals: torch.Tensor
    tris: torch.Tensor
    positions_norm: torch.Tensor

    @property
    def num_triangles(self) -> int:
        return int(self.tris.shape[0])

    @property
    def device(self) -> torch.device:
        return self.positions_norm.device

    @classmethod
    def from_obj(cls, mesh: ObjMesh, device: torch.device | str,
                 bound: np.ndarray | None = None) -> "MeshBuffers":
        b = mesh.bound() if bound is None else np.asarray(bound, dtype=np.float32)
        center = b[:3]
        half = max(float(b[3]), np.finfo(np.float32).tiny)
        # same f32 expression as the JAX package: (pos - center) / half
        pos = torch.from_numpy(np.ascontiguousarray(mesh.positions, np.float32))
        pos_norm = (pos - torch.from_numpy(center.astype(np.float32))) / torch.tensor(
            half, dtype=torch.float32
        )
        return cls(
            positions=pos.to(device),
            normals=torch.from_numpy(
                np.ascontiguousarray(mesh.normals, np.float32)
            ).to(device),
            tris=torch.from_numpy(mesh.triangles.astype(np.int64)).to(device),
            positions_norm=pos_norm.to(device),
        )
