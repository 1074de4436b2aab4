"""Time one set of frames of one checkout of the port on the card.

Run from the repository root, once per tree to compare (a checkout of any
commit of the port, e.g. one unpacked with ``git archive``), in turns:

    python3 scripts/frames.py --set gather|stab64 [TREE]
    (TREE: default this repository)

Builds TREE's kernels, then runs ``FramePipeline`` frames at 1280x720 on
the icosphere of subdivision 6 (81,920 triangles; 7, 327,680, at 256^3),
placed as ``chip_smoke.py`` places it, one frame set of :data:`SETS`:

- ``gather``: ``render_impl="gather"`` at 64^3 and 256^3, and then the
  renderer's two public calls alone on the frame's grid,
  ``precompute_light_volume`` and ``raymarch_fast`` (CUDA-event ms; the
  same signatures in every tree), as ``chip_smoke.py`` phase 20 times
  them;
- ``stab64``: the 64^3 ``-hq`` ray-stab frames (gen-6): ``-inside
  raystab`` static (the accel built once: the stream merge every frame),
  ``-inside raystab -deform`` (the refit: the per-triangle rows and the
  merge every frame, the app's wobble along the normals) and ``-normals``
  (the merge gated by the parity words).

For each frame it prints the CUDA-event ms per frame, the device busy ms,
the device ops per frame (kernels and copies), the idle share and the set's
hand kernels' device us per frame; and the card's name and power limit.
The timing is this repository's (``dxrvoxelizer_tpu_torch/bench.py``:
``cuda_ms``, ``profile_frames``, loaded by path), whichever tree is timed,
so two trees are timed alike. Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE / "scripts"))
from turns_common import by_path  # noqa: E402

# name -> the frames: (label, icosphere subdivision, VoxelizerConfig
# keywords, FramePipeline keywords, the app's wobble every frame)
SETS = {
    "gather": [
        ("64^3 gather", 6, dict(grid_size=64), dict(render_impl="gather"),
         False),
        ("256^3 gather", 7, dict(grid_size=256), dict(render_impl="gather"),
         False),
    ],
    "stab64": [
        ("64^3 -inside raystab", 6,
         dict(grid_size=64, accel_cache=False, inside_mode="raystab"), {},
         False),
        ("64^3 -inside raystab -deform", 6,
         dict(grid_size=64, accel_cache=False, inside_mode="raystab"),
         dict(deforming=True), True),
        ("64^3 -normals", 6,
         dict(grid_size=64, accel_cache=False, parity_normals=True), {},
         False),
    ],
}


def _gather_alone(rf, timing, scene, consts, cfg) -> str:
    """The gather renderer's two public calls alone on the frame's grid."""
    import numpy as np

    from dxrvoxelizer_tpu_torch.core.pipeline import voxelize

    n = cfg.grid_size
    dens = voxelize(scene.buffers, n).density().contiguous()
    light, clear = consts.local_space_light_pt, np.array(cfg.clear_color,
                                                         np.float32)
    lv = rf.precompute_light_volume(dens, light)
    lv_ms = timing.cuda_ms(lambda: rf.precompute_light_volume(dens, light))
    rm_ms = timing.cuda_ms(lambda: rf.raymarch_fast(
        dens, lv, consts.screen_to_local, consts.local_space_eye_pt, clear,
        cfg.width, cfg.height))
    return (f"; alone: precompute_light_volume {lv_ms:.4f} ms, "
            f"raymarch_fast {rm_ms:.4f} ms")


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--set", required=True, choices=sorted(SETS))
    ap.add_argument("tree", nargs="?", default=str(HERE))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("frames: needs a CUDA card", file=sys.stderr)
        return 1
    from dxrvoxelizer_tpu_torch.app.main import wobbled
    from dxrvoxelizer_tpu_torch.core.pipeline import FramePipeline
    from dxrvoxelizer_tpu_torch.models.camera import OrbitCamera
    from dxrvoxelizer_tpu_torch.models.scene import Scene
    from dxrvoxelizer_tpu_torch.ops import _cuda
    from dxrvoxelizer_tpu_torch.ops import raymarch_fast as rf
    from dxrvoxelizer_tpu_torch.utils.config import VoxelizerConfig
    from dxrvoxelizer_tpu_torch.utils.objloader import ObjMesh

    import dxrvoxelizer_tpu_torch

    timing = by_path("dxv_bench_timing",
                      HERE / "dxrvoxelizer_tpu_torch" / "bench.py")
    meshes = by_path("dxv_test_meshes", HERE / "tests" / "meshes.py")
    pkg = Path(dxrvoxelizer_tpu_torch.__file__).resolve().parents[1]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    build = _cuda.build()
    kernels = ((rf.LIGHT_VOLUME, rf.GATHER_MARCH) if args.set == "gather"
               else _cuda.all_kernels())
    dev = torch.device("cuda")
    out = []
    for label, sub, cfg_kw, pipe_kw, deform in SETS[args.set]:
        v, nrm, t = meshes.icosphere_mesh(sub)
        w = v * timing.WORLD_SCALE + timing.WORLD_CENTER
        obj = ObjMesh(positions=w, normals=nrm, indices=t.reshape(-1),
                      aabb_min=w.min(0), aabb_max=w.max(0))
        cfg = VoxelizerConfig(**cfg_kw)
        scene = Scene(obj, dev)  # the positional device every tree takes
        base = scene.buffers
        base_x = base.positions_norm[:, :1].cpu().numpy()
        cam = OrbitCamera(cfg.width, cfg.height)
        consts = scene.update_frame(cam.eye, cam.view_proj, cfg.width,
                                    cfg.height)
        pipe = FramePipeline(cfg, base, **pipe_kw)
        step = [0]

        def frame(pipe=pipe, consts=consts, deform=deform, base=base,
                  base_x=base_x):
            if deform:  # the app's wobble, a new phase every frame
                step[0] += 1
                pipe.mesh = wobbled(base, base_x, step[0])
            return pipe.frame(consts)

        img = frame()
        pipe.sync()
        assert bool(torch.isfinite(img).all()) and img.shape == (720, 1280, 3)
        ms = timing.cuda_ms(frame)
        pipe.sync()
        frame()
        pipe.sync()
        busy, ops, kus = timing.profile_frames(frame, pipe.sync, kernels)
        line = (f"{label} frame ({len(t)} tris, 1280x720): {ms:.4f} ms, "
                f"busy {busy:.4f} ms (idle share {1 - busy / ms:.3f}), "
                f"{ops:.0f} device ops per frame, kernel us per frame {kus}")
        if args.set == "gather":
            line += _gather_alone(rf, timing, scene, consts, cfg)
        out.append(line)
    print(f"frames --set {args.set} {pkg} (build {build.seconds:.1f} s): "
          + "; ".join(out) + f"; {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
