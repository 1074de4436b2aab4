from dxrvoxelizer_tpu_torch.app.main import main  # noqa: F401
