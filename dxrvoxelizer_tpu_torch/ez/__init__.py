"""EZ (ergonomic) API tier — the ``VoxelizerEZ`` analog."""

from dxrvoxelizer_tpu_torch.ez.engine import Engine  # noqa: F401
