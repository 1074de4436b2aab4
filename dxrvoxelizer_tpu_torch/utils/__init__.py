from dxrvoxelizer_tpu_torch.utils.objloader import ObjMesh, load_obj  # noqa: F401
from dxrvoxelizer_tpu_torch.utils.assets import find_asset  # noqa: F401
