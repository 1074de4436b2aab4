"""Smoke run of the PyTorch + CUDA build (``dxrvoxelizer_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (sm_90a) and
the CUDA toolkit. Phases, one line each:

1. the card (``nvidia-smi`` name and power limit) and the build of every
   kernel in ``dxrvoxelizer_tpu_torch/csrc`` from source;
2. the app's default frame, as a user runs it: 64^3 parity voxelize + ``-hq``
   shear-warp render at 1280x720, 4 orbiting frames, on a procedural
   81,920-triangle icosphere (``tests/meshes.py``) written to an OBJ at the
   world footprint of the reference's default bunny (about 8 units tall,
   centred at the camera's focus); every kernel of that path must have
   launched;
3. one ``-fast`` frame (no z-supersampling);
4. each kernel against its plain torch version on the card, at the shapes
   the main path gives it, and the whole frame against the plain path and
   against the CPU on a small input;
5. medians of 5 runs, timed with CUDA events around 10 back-to-back calls,
   of each kernel, its plain version, and the whole frame; then a profiler
   window of 5 frames for the device time per kernel and the idle share.

Any failure raises and exits non-zero. The last line is the JSON result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

FRAMES = 4
GRID = 64
# icosphere placement at the bunny's world footprint (the default camera
# focuses on (0, 4, 0); tests/goldens/render_bunny_720p.png)
WORLD_SCALE = np.float32(5.5)
WORLD_CENTER = np.array([0.0, 4.0, 0.0], np.float32)
REPS = 5  # timed runs per measurement (the median is reported)
INNER = 10  # back-to-back calls per timed run
PROFILE_FRAMES = 5
# kernel-vs-plain bounds (absolute): the march's is the JAX package's own
# kernel bound (tests/test_march_pallas.py); the resolve's absorbs the
# march's ulp-level noise through the sqrt tone curve; the frame's is the
# tet-golden bound (tests/test_goldens.py)
TOL_MARCH = 2e-6
TOL_RESOLVE = 1e-5
TOL_FRAME = 2e-3


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def write_obj(path: Path, verts: np.ndarray, tris: np.ndarray) -> None:
    lines = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in verts]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in tris]
    path.write_text("\n".join(lines) + "\n")


def cuda_ms(torch, fn) -> float:
    """Time per call of ``fn``: CUDA events around INNER back-to-back calls,
    median of REPS such runs, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(INNER):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / INNER)
    return statistics.median(times)


def _load_test_meshes(root: Path):
    """``tests/meshes.py`` (numpy only) by path: an installed package named
    ``tests`` would shadow the repository's directory of that name."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "dxv_test_meshes", root / "tests" / "meshes.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / "dxrvoxelizer_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a repository checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from dxrvoxelizer_tpu_torch.app.main import main as app_main
    from dxrvoxelizer_tpu_torch.core.pipeline import FramePipeline, VoxelGrid, render
    from dxrvoxelizer_tpu_torch.models.camera import OrbitCamera
    from dxrvoxelizer_tpu_torch.models.scene import Scene
    from dxrvoxelizer_tpu_torch.ops import (
        _cuda,
        march_cuda,
        screen_warp_cuda,
        voxelize_cuda,
    )
    from dxrvoxelizer_tpu_torch.ops.binning import bin_triangles
    from dxrvoxelizer_tpu_torch.ops.packing import pack_bits_z
    from dxrvoxelizer_tpu_torch.ops.raymarch_warp import (
        light_sweep_ref_host,
        march_inputs,
        screen_coords,
        shearwarp_statics,
    )
    from dxrvoxelizer_tpu_torch.ops.voxelize_ref import voxelize_parity_ref
    from dxrvoxelizer_tpu_torch.utils.config import VoxelizerConfig
    from dxrvoxelizer_tpu_torch.utils.image import read_png
    from dxrvoxelizer_tpu_torch.utils.objloader import load_obj
    meshes = _load_test_meshes(root)
    box_mesh = meshes.box_mesh
    icosphere_mesh = meshes.icosphere_mesh
    tetrahedron_mesh = meshes.tetrahedron_mesh

    kernels = [voxelize_cuda.KERNEL, march_cuda.KERNEL, screen_warp_cuda.KERNEL]
    dev = torch.device("cuda", 0)

    # ---- 1. card and build ----------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    info = _cuda.build()
    _cuda.load()
    regs = [ln.strip() for ln in info.log.splitlines() if "Used" in ln]
    print(f"phase 1 build: {info.seconds:.2f} s, {len(regs)} kernel "
          f"variants; ptxas: {' | '.join(regs)}")

    with tempfile.TemporaryDirectory() as td:
        obj = Path(td) / "icosphere6.obj"
        v6, _, t6 = icosphere_mesh(6)
        write_obj(obj, v6 * WORLD_SCALE + WORLD_CENTER, t6)
        # the CLI reads "/..." as a flag (reference-style prefixes)
        obj_arg = os.path.relpath(obj)

        # ---- 2. the app's default frame (the main path) -----------------
        png = Path(td) / "frame.png"
        for k in kernels:
            k.launches = 0
        rc = app_main(["-mesh", obj_arg, "-frames", str(FRAMES),
                       "-out", str(png)])
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in kernels}
        check(rc == 0, f"app exited {rc}")
        check(png.is_file(), "the app wrote no PNG")
        img = read_png(png)
        check(img.shape == (720, 1280, 3), f"PNG shape {img.shape}")
        clear_u8 = np.array([0, 51, 102])
        covered = float((np.abs(img.astype(int) - clear_u8).sum(-1) > 3).mean())
        check(0.05 < covered < 0.9, f"volume covers {covered:.3f} of the frame")
        for name, count in launches.items():
            check(count > 0, f"kernel {name} never launched on the main path")
        print(f"phase 2 app frame: {len(t6)} tris {GRID}^3 1280x720 -hq, "
              f"{FRAMES} frames, launches {launches}, volume covers "
              f"{covered:.3f} of the image")

        # ---- 3. one -fast frame -------------------------------------------
        png_fast = Path(td) / "fast.png"
        rc = app_main(["-mesh", obj_arg, "-frames", "1", "-fast",
                       "-out", str(png_fast)])
        torch.cuda.synchronize()
        check(rc == 0 and png_fast.is_file(), "-fast frame failed")
        print(f"phase 3 -fast frame: {read_png(png_fast).shape} written")

        # the main path's state, rebuilt for the comparisons
        cfg = VoxelizerConfig(mesh=str(obj))
        scene = Scene(load_obj(obj), dev, pos_scale=cfg.pos_scale,
                      light_pt=cfg.light_pt)
    cam = OrbitCamera(cfg.width, cfg.height)
    consts = scene.update_frame(cam.eye, cam.view_proj, cfg.width, cfg.height)
    pipe = FramePipeline(cfg, scene.buffers)

    # ---- 4. kernels against their plain versions ------------------------
    errs = {}

    def parity_case(name, verts, tris, n):
        mb = torch.from_numpy(np.asarray(verts, np.float32)).to(dev)
        tr = torch.from_numpy(np.asarray(tris, np.int64)).to(dev)
        coef, stats = bin_triangles(mb, tr, n)
        words = voxelize_cuda.voxelize_parity_tiles(coef, n)
        plain = voxelize_cuda.voxelize_parity_tiles_plain(coef, n)
        check(torch.equal(words, plain),
              f"parity words differ from the plain version: {name} {n}^3")
        return stats

    box_lines = []
    for n in (GRID, 256):
        c = [(i + 0.5) / n * 2 - 1 for i in (3, 5, 2, n - 6, n - 4, n - 9)]
        vb, _, tb = box_mesh(c[:3], c[3:])  # faces on voxel centers: ties
        for name, (vv, tt) in {"icosphere6": (v6, t6),
                               "box_on_centers": (vb, tb)}.items():
            stats = parity_case(name, vv, tt, n)
            box_lines.append(f"{name}@{n}^3 cap {stats.capacity}")
    # and the kernel against the independent counting oracle at 64^3
    mb = scene.buffers
    oracle = pack_bits_z(voxelize_parity_ref(mb.positions_norm, mb.tris, n=GRID))
    coef_main, stats_main = bin_triangles(mb.positions_norm, mb.tris, GRID)
    words_main = voxelize_cuda.voxelize_parity_tiles(coef_main, GRID)
    check(torch.equal(words_main, oracle), "kernel words differ from the oracle")
    errs["parity_voxelize"] = 0.0
    phase4 = [f"parity words bit-identical to the plain version "
              f"({', '.join(box_lines)}) and to the counting oracle at "
              f"{GRID}^3 (main path: {stats_main})"]

    grid = VoxelGrid(words=words_main)
    density = grid.density()
    light = light_sweep_ref_host(density, consts.local_space_light_pt, GRID)
    axis, flip, swap, m = shearwarp_statics(
        consts.screen_to_local, consts.local_space_eye_pt, cfg.width,
        cfg.height, m_cap=cfg.intermediate_cap,
    )
    march_err = {}
    for ss in (1, 2):
        mi_ss = march_inputs(density, light, consts.local_space_eye_pt, GRID,
                             m, axis, flip, ss)
        t_k, s_k = march_cuda.march(*mi_ss.args())
        t_p, s_p = march_cuda.march_plain(*mi_ss.args())
        march_err[ss] = max(max_err(t_k, t_p), max_err(s_k, s_p))
        check(march_err[ss] <= TOL_MARCH,
              f"march ss={ss} differs by {march_err[ss]:.3g}")
    errs["march"] = march_err[cfg.render_ss]
    mi = march_inputs(density, light, consts.local_space_eye_pt, GRID, m,
                      axis, flip, cfg.render_ss)
    t_i, s_i = march_cuda.march(*mi.args())
    gi_x, gi_y, ok = screen_coords(consts.screen_to_local,
                                   consts.local_space_eye_pt, cfg.width,
                                   cfg.height, axis, flip, m, mi, dev)
    if swap:
        t_i, s_i = t_i.t().contiguous(), s_i.t().contiguous()
        gi_x, gi_y = gi_y, gi_x
    clear = np.asarray(cfg.clear_color, np.float32)
    res_args = (s_i, t_i, gi_x, gi_y, ok, clear, cfg.height, cfg.width)
    img_k = screen_warp_cuda.resolve(*res_args)
    img_p = screen_warp_cuda.resolve_plain(*res_args)
    errs["resolve"] = max_err(img_k, img_p)
    check(errs["resolve"] <= TOL_RESOLVE,
          f"resolve differs by {errs['resolve']:.3g}")
    phase4.append(f"march max|err| ss=1 {march_err[1]:.3g} ss=2 "
                  f"{march_err[2]:.3g} (m={m}, swap={swap}); resolve max|err| "
                  f"{errs['resolve']:.3g}")

    def frame_kernels():
        return pipe.frame(consts)

    def frame_plain():
        words = voxelize_cuda.voxelize_parity_tiles_plain(coef_main, GRID)
        return render(VoxelGrid(words=words), consts, cfg, use_kernels=False)

    f_k = frame_kernels()
    pipe.sync()
    f_p = frame_plain()
    frame_err = max_err(f_k, f_p)
    check(bool(torch.isfinite(f_k).all()) and f_k.shape == (720, 1280, 3),
          "frame not finite or misshapen")
    check(frame_err <= TOL_FRAME, f"frame differs by {frame_err:.3g}")

    # small input: the card's frame against the CPU path (plain versions)
    vt, nt_, tt = tetrahedron_mesh()
    small = VoxelizerConfig(grid_size=32, width=96, height=64)
    from dxrvoxelizer_tpu_torch.utils.objloader import ObjMesh

    tet = ObjMesh(positions=vt, normals=nt_, indices=tt.reshape(-1),
                  aabb_min=vt.min(0), aabb_max=vt.max(0))
    small_err = {}
    for ss in (1, 2):
        scfg = small.replace(render_ss=ss)
        imgs = []
        for d in (dev, torch.device("cpu")):
            sc = Scene(tet, d)
            scam = OrbitCamera(scfg.width, scfg.height)
            fc = sc.update_frame(scam.eye, scam.view_proj, scfg.width,
                                 scfg.height)
            imgs.append(FramePipeline(scfg, sc.buffers).frame(fc).cpu())
        small_err[ss] = max_err(imgs[0], imgs[1])
        check(small_err[ss] <= TOL_FRAME,
              f"tet frame ss={ss} GPU vs CPU differs by {small_err[ss]:.3g}")
    phase4.append(f"frame max|err| kernels vs plain {frame_err:.3g}; tet "
                  f"32^3 96x64 GPU vs CPU ss=1 {small_err[1]:.3g} ss=2 "
                  f"{small_err[2]:.3g}")
    print("phase 4 " + "; ".join(phase4))

    # ---- 5. timings ------------------------------------------------------
    ms = {
        "parity_voxelize": (
            cuda_ms(torch, lambda: voxelize_cuda.voxelize_parity_tiles(coef_main, GRID)),
            cuda_ms(torch, lambda: voxelize_cuda.voxelize_parity_tiles_plain(coef_main, GRID)),
        ),
        "march": (
            cuda_ms(torch, lambda: march_cuda.march(*mi.args())),
            cuda_ms(torch, lambda: march_cuda.march_plain(*mi.args())),
        ),
        "resolve": (
            cuda_ms(torch, lambda: screen_warp_cuda.resolve(*res_args)),
            cuda_ms(torch, lambda: screen_warp_cuda.resolve_plain(*res_args)),
        ),
    }
    frame_ms = cuda_ms(torch, frame_kernels)
    pipe.sync()
    frame_plain_ms = cuda_ms(torch, frame_plain)

    # device time by kernel over a steady window of frames (profiler): what
    # the card is busy with per frame, and how long it idles
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_FRAMES):
            frame_kernels()
        pipe.sync()
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    dev_events = [e for e in prof.key_averages()
                  if str(e.device_type) == "DeviceType.CUDA"]
    dev_us = {e.key: e.self_device_time_total for e in dev_events}
    busy_ms = sum(dev_us.values()) / PROFILE_FRAMES / 1e3
    launches_per_frame = sum(e.count for e in dev_events) / PROFILE_FRAMES
    kernel_us = {
        k.name: sum(us for key, us in dev_us.items() if k.symbol in key)
        / PROFILE_FRAMES for k in kernels
    }
    print(f"phase 5 frame {GRID}^3 1280x720 -hq: {frame_ms:.4f} ms with the "
          f"kernels, {frame_plain_ms:.4f} ms plain (CUDA events over "
          f"{INNER} back-to-back runs, median of {REPS}); profiled: device "
          f"busy {busy_ms:.4f} ms per frame (idle share "
          f"{1 - busy_ms / frame_ms:.3f}), {launches_per_frame:.0f} device "
          f"kernels and copies per frame, kernel device us per frame "
          f"{ {k: round(v, 3) for k, v in kernel_us.items()} }, peak device "
          f"memory {peak_mib:.1f} MiB; {card}")

    result = {"kernels": [
        {"name": k.name, "route": k.route, "source": k.source,
         "replaces": k.replaces, "launches": launches[k.name],
         "max_abs_err": errs[k.name], "ms": ms[k.name][0],
         "plain_ms": ms[k.name][1]}
        for k in kernels
    ]}
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
