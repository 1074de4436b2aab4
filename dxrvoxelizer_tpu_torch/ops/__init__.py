"""Voxelize and render ops. ``*_cuda.py`` modules hold a hand-written CUDA
kernel's wrapper and its plain torch version (``raymarch_fast.py`` holds
two, for what is XLA code in the JAX package); kernels build on first use."""

from dxrvoxelizer_tpu_torch.ops.voxelize_ref import voxelize_parity_ref  # noqa: F401
