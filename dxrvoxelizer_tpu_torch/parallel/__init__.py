"""Multi-device scale-out (port of ``dxrvoxelizer_tpu/parallel``): one rank
per device in a ``torch.distributed`` process group, each frame's one
all_gather between its voxelize and its band render
(``shard``/``raystab_shard``), the FramePipeline-compatible product surface
(``pipeline.ShardedFramePipeline``) and batch datagen (``datagen``).
Importing it starts no process group."""

from dxrvoxelizer_tpu_torch.parallel.mesh import (  # noqa: F401
    DeviceGroup,
    make_device_mesh,
    make_local_group,
    spawn_ranks,
)
from dxrvoxelizer_tpu_torch.parallel.pipeline import (  # noqa: F401
    ShardedFramePipeline,
)
from dxrvoxelizer_tpu_torch.parallel.shard import (  # noqa: F401
    sharded_frame,
    sharded_frame_fast,
    sharded_voxelize,
    voxelize_parity_multichip,
)
