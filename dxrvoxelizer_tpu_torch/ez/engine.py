"""Stateful engine with the reference renderer-class surface.

Port of ``dxrvoxelizer_tpu/ez/engine.py``: ``VoxelizerEZ::{Init,
UpdateFrame, Render}`` (Content/VoxelizerEZ.h:17-23). ``Engine`` wires scene
loading, per-frame constants, voxelize and ray-march; per-frame constants
are slot-indexed like the reference's triple-buffered CBV sets. The
alternate pipeline (X-key switch) and multi-device frames are not ported
yet (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from dxrvoxelizer_tpu_torch.core.pipeline import (
    FRAME_COUNT,
    FramePipeline,
    VoxelGrid,
    render,
    voxelize,
)
from dxrvoxelizer_tpu_torch.models.scene import FrameConstants, Scene
from dxrvoxelizer_tpu_torch.utils.config import VoxelizerConfig


class Engine:
    """Load once, then per frame: ``update_frame`` + ``render``."""

    def __init__(self, cfg: VoxelizerConfig, device: torch.device | str,
                 scene: Scene | None = None, vox_impl: str = "auto",
                 render_impl: str = "warp", deforming: bool = False):
        self.cfg = cfg
        self.device = torch.device(device)
        self.scene = scene if scene is not None else Scene.load(cfg, self.device)
        self.pipeline = FramePipeline(
            cfg, self.scene.buffers, vox_impl=vox_impl, render_impl=render_impl,
            deforming=deforming,
        )
        self._consts: list[FrameConstants | None] = [None] * FRAME_COUNT

    # -- reference surface ---------------------------------------------------
    def update_frame(self, frame_index: int, eye_pt, view_proj) -> None:
        """Voxelizer::UpdateFrame analog (Content/Voxelizer.cpp:81-106)."""
        self._consts[frame_index % FRAME_COUNT] = self.scene.update_frame(
            np.asarray(eye_pt, dtype=np.float32),
            np.asarray(view_proj, dtype=np.float32),
            self.cfg.width,
            self.cfg.height,
        )

    def render(self, frame_index: int) -> torch.Tensor:
        """Voxelizer::Render analog: voxelize + ray-cast one frame."""
        consts = self._consts[frame_index % FRAME_COUNT]
        if consts is None:
            raise RuntimeError("update_frame must be called before render")
        return self.pipeline.frame(consts)

    # -- conveniences --------------------------------------------------------
    def voxelize_only(self) -> VoxelGrid:
        return voxelize(
            self.scene.buffers, self.cfg.grid_size, mode=self.cfg.inside_mode,
            impl=self.pipeline.vox_impl,
        )

    def render_grid(self, grid: VoxelGrid, consts: FrameConstants) -> torch.Tensor:
        return render(grid, consts, self.cfg, impl=self.pipeline.render_impl)

    def sync(self) -> None:
        self.pipeline.sync()
