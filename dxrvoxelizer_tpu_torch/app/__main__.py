import sys

from dxrvoxelizer_tpu_torch.app.main import main

if __name__ == "__main__":  # spawned -chips ranks import this module too
    sys.exit(main(sys.argv[1:]))
