"""State carried across from the JAX package.

The two packages share no objects: the JAX package's arrays, taken to the
host as numpy, become this package's tensors here, so both compute on
identical inputs (the tests compare them this way).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from dxrvoxelizer_tpu_torch.core.pipeline import VoxelGrid
from dxrvoxelizer_tpu_torch.models.mesh import MeshBuffers

MESH_FIELDS = ("positions", "normals", "tris", "positions_norm")


def mesh_buffers_from_numpy(d: Mapping[str, np.ndarray],
                            device: torch.device | str) -> MeshBuffers:
    """``MeshBuffers`` from the JAX ``MeshBuffers`` fields as numpy arrays
    (``{f: np.asarray(getattr(mb, f)) for f in MESH_FIELDS}``)."""
    return MeshBuffers(
        positions=torch.tensor(np.asarray(d["positions"], np.float32)).to(device),
        normals=torch.tensor(np.asarray(d["normals"], np.float32)).to(device),
        tris=torch.tensor(np.asarray(d["tris"], np.int64)).to(device),
        positions_norm=torch.tensor(
            np.asarray(d["positions_norm"], np.float32)
        ).to(device),
    )


def grid_from_numpy(words: np.ndarray, device: torch.device | str) -> VoxelGrid:
    """``VoxelGrid`` from packed occupancy words [N, N, N//32] int32."""
    w = np.asarray(words)
    if w.dtype != np.int32 or w.ndim != 3 or w.shape[2] * 32 != w.shape[0]:
        raise ValueError(f"expected int32 words [N, N, N//32], got {w.dtype} {w.shape}")
    return VoxelGrid(words=torch.tensor(w).to(device))
