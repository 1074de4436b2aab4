"""Stateful engine with the reference renderer-class surface.

Port of ``dxrvoxelizer_tpu/ez/engine.py``: ``VoxelizerEZ::{Init,
UpdateFrame, Render}`` (Content/VoxelizerEZ.h:17-23). ``Engine`` wires scene
loading, per-frame constants, voxelize and ray-march; per-frame constants
are slot-indexed like the reference's triple-buffered CBV sets. The X key's
alternate pipeline (``toggle_path``) is an independent implementation of
both passes. ``chips > 1`` runs every frame across the ranks of a device
group (parallel/pipeline.py ``ShardedFramePipeline``): each rank's
``render`` returns its band of the image.
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
from dxrvoxelizer_tpu_torch.utils.device import config_device


class Engine:
    """Load once, then per frame: ``update_frame`` + ``render``.

    The JAX package's signature, ``Engine(cfg, scene=None, vox_impl=...,
    render_impl=..., deforming=..., chips=...)``, with ``device`` as a
    keyword: by default the scene's device, or without a scene the
    configuration's, as the app picks it (the CPU for ``-warp``/``-cpu``,
    else the CUDA device). A ``str`` or ``torch.device`` in the second
    position is taken as the device (``Engine(cfg, "cpu", scene=...)``)."""

    def __init__(self, cfg: VoxelizerConfig,
                 scene_or_device: Scene | torch.device | str | None = None,
                 vox_impl: str = "auto", render_impl: str = "warp",
                 deforming: bool = False, chips: int = 0, *,
                 scene: Scene | None = None,
                 device: torch.device | str | None = None):
        if isinstance(scene_or_device, (str, torch.device)):
            if device is not None:
                raise TypeError("Engine: device given twice")
            device = scene_or_device
        elif scene_or_device is not None:
            if scene is not None:
                raise TypeError("Engine: scene given twice")
            scene = scene_or_device
        if scene is None:
            device = config_device(cfg) if device is None else device
            scene = Scene.load(cfg, device)
        elif device is not None:
            want, have = torch.device(device), scene.buffers.device
            if want.type != have.type or want.index not in (None, have.index):
                raise ValueError(f"Engine: device {want}, but the scene lies "
                                 f"on {have}")
        self.cfg = cfg
        self.scene = scene
        self.device = scene.buffers.device
        if chips > 1:
            # scale-out: each frame across the device group's ranks
            from dxrvoxelizer_tpu_torch.parallel import ShardedFramePipeline

            self.pipeline = ShardedFramePipeline(
                cfg, self.scene.buffers, chips, vox_impl=vox_impl,
                render_impl=render_impl, deforming=deforming)
        else:
            self.pipeline = FramePipeline(
                cfg, self.scene.buffers, vox_impl=vox_impl,
                render_impl=render_impl, deforming=deforming,
            )
        self._consts: list[FrameConstants | None] = [None] * FRAME_COUNT
        self.last_grid: VoxelGrid | None = None
        # the reference keeps TWO complete pipelines alive and the X key
        # swaps voxelize AND render between them (DXRVoxelizer.cpp:190-199,
        # 295-297, 420-481); the alternate here is the counting oracle +
        # the gather ray-marcher, built on the first switch
        self.use_alt = False
        self._pipeline_alt: FramePipeline | None = None

    @property
    def pipeline_alt(self) -> FramePipeline:
        """The alternate (oracle voxelize + gather render) pipeline."""
        if self._pipeline_alt is None:
            self._pipeline_alt = FramePipeline(
                self.cfg, self.pipeline.mesh, vox_impl="xla",
                render_impl="gather",
            )
        return self._pipeline_alt

    def toggle_path(self) -> bool:
        """X-key analog: swap the ACTIVE pipeline (voxelize + render).

        Returns True when the alternate pipeline is now active.
        """
        self.use_alt = not self.use_alt
        return self.use_alt

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
        """Voxelizer::Render analog: voxelize + ray-cast one frame on the
        active pipeline."""
        consts = self._consts[frame_index % FRAME_COUNT]
        if consts is None:
            raise RuntimeError("update_frame must be called before render")
        if self.use_alt:
            alt = self.pipeline_alt
            alt.mesh = self.pipeline.mesh  # track deforming-geometry swaps
            return alt.frame(consts)
        return self.pipeline.frame(consts)

    # -- conveniences --------------------------------------------------------
    def voxelize_only(self) -> VoxelGrid:
        grid = voxelize(
            self.scene.buffers, self.cfg.grid_size, mode=self.cfg.inside_mode,
            impl=self.pipeline.vox_impl,
        )
        self.last_grid = grid
        return grid

    def render_grid(self, grid: VoxelGrid, consts: FrameConstants) -> torch.Tensor:
        return render(grid, consts, self.cfg, impl=self.pipeline.render_impl)

    def sync(self) -> None:
        self.pipeline.sync()
        if self._pipeline_alt is not None:
            self._pipeline_alt.sync()
