"""Time the gather renderer's frames of one checkout of the port on the card.

Run from the repository root, once per tree to compare (a checkout of any
commit of the port, e.g. one unpacked with ``git archive``), in turns:

    python3 scripts/gather_frames.py [TREE]   (default: this repository)

Builds TREE's kernels, then runs ``FramePipeline(render_impl="gather")``
frames at 64^3 and 256^3 on the icospheres of subdivision 6 (81,920
triangles) and 7 (327,680) at 1280x720, placed as ``chip_smoke.py`` places
them, and prints per frame: CUDA-event ms, device busy ms and device ops,
the idle share and the two gather kernels' device us per frame; then the
renderer's two public calls alone on the frame's grid,
``precompute_light_volume`` and ``raymarch_fast`` (CUDA-event ms; the same
signatures in every tree); and the card's name and power limit. The timing
is this repository's (``dxrvoxelizer_tpu_torch/bench.py``: ``cuda_ms``,
``profile_frames``, loaded by path), whichever tree is timed, so two trees
are timed alike and as ``chip_smoke.py`` phase 20 times them. Needs a CUDA
card; imports no JAX.
"""

from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _by_path(name: str, path: Path):
    """A module by path: an installed package named ``tests`` would shadow
    the repository's directory of that name."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv: list[str]) -> int:
    tree = Path(argv[0]).resolve() if argv else HERE
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("gather_frames: needs a CUDA card", file=sys.stderr)
        return 1
    from dxrvoxelizer_tpu_torch.core.pipeline import FramePipeline, voxelize
    from dxrvoxelizer_tpu_torch.models.camera import OrbitCamera
    from dxrvoxelizer_tpu_torch.models.scene import Scene
    from dxrvoxelizer_tpu_torch.ops import _cuda
    from dxrvoxelizer_tpu_torch.ops import raymarch_fast as rf
    from dxrvoxelizer_tpu_torch.utils.config import VoxelizerConfig
    from dxrvoxelizer_tpu_torch.utils.objloader import ObjMesh

    import dxrvoxelizer_tpu_torch

    timing = _by_path("dxv_bench_timing",
                      HERE / "dxrvoxelizer_tpu_torch" / "bench.py")
    pkg = Path(dxrvoxelizer_tpu_torch.__file__).resolve().parents[1]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    build = _cuda.build()
    meshes = _by_path("dxv_test_meshes", HERE / "tests" / "meshes.py")
    kernels = (rf.LIGHT_VOLUME, rf.GATHER_MARCH)
    dev = torch.device("cuda")
    out = []
    for sub, n in ((6, 64), (7, 256)):
        v, nrm, t = meshes.icosphere_mesh(sub)
        w = v * timing.WORLD_SCALE + timing.WORLD_CENTER
        obj = ObjMesh(positions=w, normals=nrm, indices=t.reshape(-1),
                      aabb_min=w.min(0), aabb_max=w.max(0))
        cfg = VoxelizerConfig(grid_size=n)
        scene = Scene(obj, dev)  # the positional device every tree takes
        cam = OrbitCamera(cfg.width, cfg.height)
        consts = scene.update_frame(cam.eye, cam.view_proj, cfg.width,
                                    cfg.height)
        pipe = FramePipeline(cfg, scene.buffers, render_impl="gather")

        def frame(pipe=pipe, consts=consts):
            return pipe.frame(consts)

        img = frame()
        pipe.sync()
        assert bool(torch.isfinite(img).all()) and img.shape == (720, 1280, 3)
        ms = timing.cuda_ms(frame)
        pipe.sync()
        frame()
        pipe.sync()
        busy, ops, kus = timing.profile_frames(frame, pipe.sync, kernels)
        dens = voxelize(scene.buffers, n).density().contiguous()
        light, clear = consts.local_space_light_pt, np.array(cfg.clear_color,
                                                             np.float32)
        lv = rf.precompute_light_volume(dens, light)
        lv_ms = timing.cuda_ms(lambda: rf.precompute_light_volume(dens, light))
        rm_ms = timing.cuda_ms(lambda: rf.raymarch_fast(
            dens, lv, consts.screen_to_local, consts.local_space_eye_pt, clear,
            cfg.width, cfg.height))
        out.append(f"{n}^3 gather frame ({len(t)} tris, 1280x720): {ms:.4f} ms, "
                   f"busy {busy:.4f} ms (idle share {1 - busy / ms:.3f}), "
                   f"{ops:.0f} device ops per frame, kernel us per frame {kus}; "
                   f"alone: precompute_light_volume {lv_ms:.4f} ms, "
                   f"raymarch_fast {rm_ms:.4f} ms")
    print(f"gather_frames {pkg} (build {build.seconds:.1f} s): "
          + "; ".join(out) + f"; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
