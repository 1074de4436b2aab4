"""dxrvoxelizer_tpu_torch — the PyTorch + CUDA build of dxrvoxelizer_tpu.

A second package beside the JAX one (``dxrvoxelizer_tpu``, the reference):
load a Wavefront-OBJ mesh, solid-voxelize it every frame into packed
occupancy words, and ray-march the grid to the screen (shear-warp by
default; the gather renderer and the shader-exact oracle on request), on an
NVIDIA GPU through hand-written CUDA kernels (``csrc/``), or on the CPU
through each kernel's plain torch version (``-warp``).

The layout mirrors the JAX package module for module; a Pallas module
``ops/x_pallas.py`` there is ``ops/x_cuda.py`` here. This package imports
torch and never JAX, and builds no kernel at import time.

- ``core``   — explicit pass functions and the frame pipeline.
- ``ez``     — stateful ``Engine``.
- ``models`` — mesh / scene / camera state.
- ``ops``    — voxelize and render ops, CUDA kernel wrappers + plain versions.
- ``utils``  — OBJ loader, DirectXMath-convention matrices, timer, PNG,
  device, profiling.
- ``app``    — CLI (``python -m dxrvoxelizer_tpu_torch.app -mesh x.obj``),
  the interactive hotkey loop and the live HTTP preview.
- ``state``  — turn the JAX package's arrays (as numpy) into this package's.
"""

__version__ = "0.1.0"

from dxrvoxelizer_tpu_torch.models.scene import Scene  # noqa: F401
from dxrvoxelizer_tpu_torch.models.camera import OrbitCamera  # noqa: F401
from dxrvoxelizer_tpu_torch.utils.config import VoxelizerConfig  # noqa: F401
