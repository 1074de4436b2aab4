"""Core (explicit) API tier: the caller owns buffers and invokes each pass
(the reference's ``Voxelizer``, Content/Voxelizer.{h,cpp})."""

from dxrvoxelizer_tpu_torch.core.pipeline import (  # noqa: F401
    FRAME_COUNT,
    FramePipeline,
    VoxelGrid,
    render,
    voxelize,
)
