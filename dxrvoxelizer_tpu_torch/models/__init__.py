from dxrvoxelizer_tpu_torch.models.mesh import MeshBuffers  # noqa: F401
from dxrvoxelizer_tpu_torch.models.scene import Scene  # noqa: F401
from dxrvoxelizer_tpu_torch.models.camera import OrbitCamera  # noqa: F401
