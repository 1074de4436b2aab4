"""Count what the gen-7 and gen-6 ray-stab accels of the CUDA build hold for
an icosphere (candidate rows, live tiles or strips, and gen-7's (tile,
candidate) pairs before the near drop), on the CPU: counts, no times.

    python scripts/raystab7_counts.py [n] [icosphere subdivisions]

Defaults: n = 128, subdivisions 6 (81,920 triangles, unit radius).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from meshes import icosphere_mesh  # noqa: E402

from dxrvoxelizer_tpu_torch.ops import raystab_fast, raystab_tiled  # noqa: E402


def main(argv: list[str]) -> int:
    n = int(argv[0]) if argv else 128
    level = int(argv[1]) if len(argv) > 1 else 6
    v, _, t = icosphere_mesh(level)
    v = torch.from_numpy(np.asarray(v, np.float32))
    t = torch.from_numpy(np.asarray(t, np.int64))
    before = []
    repeat = torch.repeat_interleave

    def counting(*args, **kwargs):  # the CSR expansion's size: pairs before the drop
        if "output_size" in kwargs:
            before.append(kwargs["output_size"])
        return repeat(*args, **kwargs)

    torch.repeat_interleave = counting
    try:
        c7 = raystab_tiled.build_raystab_compact7(v, t, n)
    finally:
        torch.repeat_interleave = repeat
    c6 = raystab_fast.build_raystab_compact2(v, t, n)
    rows6 = sum(int((tab >= 0).sum()) for _, tab, _ in c6.classes)
    strips6 = sum(tab.shape[0] for _, tab, _ in c6.classes)
    print(f"{int(t.shape[0])} triangles at {n}^3: gen-7 {c7.stats.pairs} "
          f"candidate rows over {c7.stats.live_tiles} live tiles "
          f"({before[0]} (tile, candidate) pairs before the near drop); "
          f"gen-6 {rows6} candidate rows over {strips6} strips")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
