"""Time the ray-stab fold kernels on static accels, for one checkout of the
port on the card.

Run from the repository root, once per tree to compare (a checkout of any
commit of the port, e.g. one unpacked with ``git archive``), in turns:

    python3 scripts/static_fold_turns.py [TREE]   (default: this repository)

Builds TREE's kernels and its static ray-stab accels, as the frames without
``-deform`` build them: gen-6 at 64^3 on the icosphere of subdivision 6
(81,920 triangles) and gen-7 at 256^3 on that of subdivision 7 (327,680),
placed as ``chip_smoke.py`` places them. On each accel's main stream (its
materialised rows, the direct instance of ``csrc/raystab_fold.cu``) it
times the fold + extraction (kernels 2.5/2.6) and the fold alone (2.7):
CUDA-event ms per call and profiler device us per call. Prints one line with
the card's name and power limit. The timing is this repository's
(``dxrvoxelizer_tpu_torch/bench.py``: ``cuda_ms``, ``device_us``, loaded by
path), whichever tree is timed, so two trees are timed alike. Needs a CUDA
card; imports no JAX.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE / "scripts"))
from turns_common import by_path  # noqa: E402


def main(argv: list[str]) -> int:
    tree = Path(argv[0]).resolve() if argv else HERE
    sys.path.insert(0, str(tree))
    import torch

    timing = by_path("dxv_bench_timing",
                      HERE / "dxrvoxelizer_tpu_torch" / "bench.py")
    meshes = by_path("dxv_test_meshes", HERE / "tests" / "meshes.py")
    if not torch.cuda.is_available():
        print("static_fold_turns: needs a CUDA card", file=sys.stderr)
        return 1
    from dxrvoxelizer_tpu_torch.models.scene import Scene
    from dxrvoxelizer_tpu_torch.ops import _cuda
    from dxrvoxelizer_tpu_torch.ops import raystab_cuda as rsc
    from dxrvoxelizer_tpu_torch.ops import raystab_fast as rsf
    from dxrvoxelizer_tpu_torch.ops import raystab_tiled as rst
    from dxrvoxelizer_tpu_torch.utils.config import VoxelizerConfig
    from dxrvoxelizer_tpu_torch.utils.objloader import ObjMesh

    import dxrvoxelizer_tpu_torch

    pkg = Path(dxrvoxelizer_tpu_torch.__file__).resolve().parents[1]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    build = _cuda.build()
    dev = torch.device("cuda")
    thr = VoxelizerConfig().inside_threshold
    out = []
    for sub, n, gen, build_accel in (
            (6, 64, "gen-6", rsf.build_raystab_accel2),
            (7, 256, "gen-7", rst.build_raystab_accel7)):
        v, nrm, t = meshes.icosphere_mesh(sub)
        w = v * timing.WORLD_SCALE + timing.WORLD_CENTER
        obj = ObjMesh(positions=w, normals=nrm, indices=t.reshape(-1),
                      aabb_min=w.min(0), aabb_max=w.max(0))
        mb = Scene(obj, dev).buffers
        accel = build_accel(mb.positions_norm, mb.tris, mb.normals, n=n)
        tb = accel.main
        assert getattr(tb, "row_ids", None) is None, "a static stream holds rows"
        t_count = int(mb.tris.shape[0])
        fns = {"fold + extraction": lambda tb=tb: rsc.fold_extract(
                   tb, t_count, thr),
               "fold alone": lambda tb=tb: rsc.fold(tb)}
        for name, fn in fns.items():
            ms = timing.cuda_ms(fn)
            us = timing.device_us(fn)
            out.append(f"{gen} {n}^3 {name} {ms:.4f} ms {us:.2f} us")
        del accel, tb, mb
        torch.cuda.empty_cache()
    print(f"static_fold_turns {pkg} (build {build.seconds:.1f} s): "
          + "; ".join(out) + f"; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
