import sys

from dxrvoxelizer_tpu_torch.app.main import main

sys.exit(main(sys.argv[1:]))
