"""Application shell: CLI, frame loop, FPS stats, capture sinks.

Port of ``dxrvoxelizer_tpu/app/main.py``. The reference app
(DXRVoxelizer/DXRVoxelizer.cpp) runs an interactive Win32 loop with an orbit
camera, 1 Hz FPS stats (CalculateFrameStats, :553-584), F11 PNG screenshots
(:531-551) and runtime path switching with X (:295-297). Headless analog:

- the reference's CLI (``-mesh <file> [x y z scale]``, ``-warp`` -> the
  CPU device, ``-``/``/`` prefixes, DXRVoxelizer.cpp:363-408), plus the
  JAX package's extensions: ``-grid -width -height -frames -out -hq -fast
  -quality -inside -normals -showmip -usemutex -pointlight -noorbit
  -voximpl -renderimpl -deform -savegrid -loadgrid -timings -ab -profile
  -interactive -preview [PORT]``;
- a frame loop that orbits the camera (the mouse-drag analog), prints FPS
  at 1 Hz, and writes PNG / .npy artifacts. ``-deform`` wobbles the
  vertices along their normals every frame, so every frame re-bins and
  re-voxelizes the mesh (the deforming configuration).

``-chips N`` runs every frame across N ranks (parallel/): on N cards, one
NCCL rank per card, or with ``-warp`` N gloo ranks on the CPU. The app
spawns the ranks itself, or joins the group a launcher made (``torchrun
--nproc-per-node N``, read from its ``WORLD_SIZE``/``RANK``/``LOCAL_RANK``);
rank 0 alone prints, writes the PNG and ``.npy`` files and serves
``-preview``.

    python -m dxrvoxelizer_tpu_torch.app -mesh bunny.obj -frames 8 -out f.png
    python -m dxrvoxelizer_tpu_torch.app -mesh bunny.obj -grid 256 -deform
    python -m dxrvoxelizer_tpu_torch.app -mesh bunny.obj -renderimpl gather -ab
    python -m dxrvoxelizer_tpu_torch.app -mesh bunny.obj -chips 2 -warp
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys

import numpy as np
import torch

from dxrvoxelizer_tpu_torch.ez import Engine
from dxrvoxelizer_tpu_torch.models.camera import OrbitCamera
from dxrvoxelizer_tpu_torch.utils.config import parse_args
from dxrvoxelizer_tpu_torch.utils.image import (
    save_grid_npy,
    screenshot_name,
    write_png,
)
from dxrvoxelizer_tpu_torch.utils.timer import StepTimer


def _parse_extras(argv: list[str]) -> dict:
    """Extension flags (reference-style prefixes)."""
    out = {
        "frames": 8,
        "out": None,
        "save_grid": None,
        "orbit": True,
        "vox_impl": "auto",
        "render_impl": "warp",
        "timings": False,
        "ab": False,
        "deform": False,
        "interactive": False,
        "load_grid": None,
        "profile": None,
        "chips": 0,
        "preview": None,  # None = off; -1 = any free port; else the port
    }
    i = 0
    while i < len(argv):
        a = argv[i]
        key = a[1:].lower() if a[:1] in "-/" else ""
        if key == "frames" and i + 1 < len(argv):
            out["frames"] = int(argv[i + 1])
        elif key == "out" and i + 1 < len(argv):
            out["out"] = argv[i + 1]
        elif key == "savegrid" and i + 1 < len(argv):
            out["save_grid"] = argv[i + 1]
        elif key == "noorbit":
            out["orbit"] = False
        elif key == "voximpl" and i + 1 < len(argv):
            out["vox_impl"] = argv[i + 1]
        elif key == "renderimpl" and i + 1 < len(argv):
            out["render_impl"] = argv[i + 1]
        elif key == "timings":
            out["timings"] = True
        elif key == "ab":
            out["ab"] = True
        elif key == "deform":
            out["deform"] = True
        elif key == "interactive":
            out["interactive"] = True
        elif key == "loadgrid" and i + 1 < len(argv):
            out["load_grid"] = argv[i + 1]
        elif key == "profile" and i + 1 < len(argv):
            out["profile"] = argv[i + 1]
        elif key == "chips" and i + 1 < len(argv):
            out["chips"] = int(argv[i + 1])
        elif key == "preview":
            # optional port operand: -preview [PORT]
            port = -1
            if i + 1 < len(argv):
                try:
                    port = int(argv[i + 1])
                except ValueError:
                    port = -1
            out["preview"] = port
        i += 1
    return out


def wobbled(base_mesh, base_x: np.ndarray, frame: int):
    """The deforming configuration's per-frame vertex wobble along the
    normals (JAX app, -deform): the amplitude in float32 numpy, as there,
    so the deformed positions are the same bits; added on the device."""
    t = frame / 15.0
    amp = 0.03 * np.sin(2 * np.pi * t + base_x * 5.0)  # [V, 1] float32
    amp_d = torch.from_numpy(amp)
    if base_mesh.device.type == "cuda":
        # pinned + non-blocking: the upload does not wait for queued frames
        amp_d = amp_d.pin_memory().to(base_mesh.device, non_blocking=True)
    pos = base_mesh.positions_norm + amp_d * base_mesh.normals
    return dataclasses.replace(base_mesh, positions_norm=pos)


def _render_saved_grid(engine, cam, cfg, path: str, render_impl: str,
                       out: str | None) -> str:
    """-loadgrid: render a saved grid (packed words, or a boolean occupancy
    grid) without re-voxelizing -> the PNG written."""
    from dxrvoxelizer_tpu_torch.core.pipeline import VoxelGrid, render
    from dxrvoxelizer_tpu_torch.ops.packing import pack_bits_z

    occ = np.load(path)
    if occ.dtype == np.int32 and occ.ndim == 3 and occ.shape[2] * 32 == occ.shape[0]:
        grid = VoxelGrid(words=torch.from_numpy(occ).to(engine.device))
    else:
        grid = VoxelGrid(words=pack_bits_z(
            torch.from_numpy(occ.astype(bool)).to(engine.device)))
    consts = engine.scene.update_frame(cam.eye, cam.view_proj, cfg.width,
                                       cfg.height)
    img = render(grid, consts, cfg, impl=render_impl)
    out = out or screenshot_name()
    write_png(out, img.cpu().numpy())
    return out


def _ab(engine, cam, cfg, base_mesh) -> bool:
    """-ab: the voxelizer's fast path against its oracle, words bit for bit,
    then the two full pipelines' images (shear-warp primary against the
    gather renderer) within mean 0.03 and p99 0.35."""
    from dxrvoxelizer_tpu_torch.core.pipeline import render, voxelize

    engine.pipeline.mesh = base_mesh
    # the oracle matches the fast path's contract: on the card the ray-stab
    # accels run radial-form intersections, whose bit-exact ground truth is
    # the radial oracle; everywhere else the Moller-Trumbore oracle
    oracle = "xla"
    if cfg.inside_mode == "raystab" and engine.device.type == "cuda":
        oracle = "xla-radial"
    a = voxelize(base_mesh, cfg.grid_size, mode=cfg.inside_mode, impl="auto")
    b = voxelize(base_mesh, cfg.grid_size, mode=cfg.inside_mode, impl=oracle)
    same = bool(torch.equal(a.words, b.words))
    print(f"A/B voxelizer paths identical: {same}")
    if not same:
        return False
    consts = engine.scene.update_frame(cam.eye, cam.view_proj, cfg.width,
                                       cfg.height)
    diff = (engine.render_grid(a, consts)
            - render(b, consts, cfg, impl="gather")).abs().cpu().numpy()
    mean_err = float(diff.mean())
    p99_err = float(np.percentile(diff, 99))
    ok = mean_err < 0.03 and p99_err < 0.35
    print(f"A/B rendered images: mean|err|={mean_err:.4f} p99={p99_err:.4f} "
          f"-> {'OK' if ok else 'FAIL'}")
    return ok


def _rank_run(argv: list[str]) -> int:
    """One rank of ``-chips N`` (its process group initialised): rank 0
    prints, the others run silently."""
    import torch.distributed as dist

    if dist.get_rank() == 0:
        return main(argv)
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        return main(argv)


def _rank_main(argv: list[str]) -> None:
    """Entry of a spawned rank: a non-zero exit code fails the launch."""
    code = _rank_run(argv)
    if code:
        raise SystemExit(code)


def _launch_ranks(argv: list[str], cfg, chips: int) -> int:
    """``-chips N`` without a process group: join the one a launcher
    describes in the environment (torchrun), else spawn N ranks here (one
    per card under NCCL, or N gloo ranks on the CPU with ``-warp``). Raises
    when the machine has fewer than N cards; never falls back to the CPU."""
    import torch.distributed as dist

    from dxrvoxelizer_tpu_torch.parallel.mesh import spawn_ranks

    cpu = cfg.backend == "cpu"
    if "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        if world != chips:
            raise ValueError(f"-chips {chips}, but the launcher started "
                             f"{world} ranks")
        if not cpu:
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("gloo" if cpu else "nccl", init_method="env://")
        try:
            return _rank_run(argv)
        finally:
            dist.destroy_process_group()
    spawn_ranks(_rank_main, chips, args=(argv,), cpu=cpu)
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    cfg = parse_args(argv)
    extras = _parse_extras(argv)
    chips = extras["chips"]
    rank = 0
    if chips > 1:
        import torch.distributed as dist

        if not dist.is_initialized():
            return _launch_ranks(argv, cfg, chips)
        rank = dist.get_rank()
    # CUDA unless -warp/-cpu asks for the CPU (the Engine's default device);
    # no silent fallback
    engine = Engine(cfg, vox_impl=extras["vox_impl"],
                    render_impl=extras["render_impl"],
                    deforming=extras["deform"], chips=chips)
    sharded = chips > 1
    cam = OrbitCamera(cfg.width, cfg.height)
    timer = StepTimer()
    print(
        f"dxrvoxelizer_tpu_torch: {cfg.mesh} "
        f"({engine.scene.buffers.num_triangles} tris) grid={cfg.grid_size}^3 "
        f"{cfg.width}x{cfg.height} ss={cfg.render_ss} mode={cfg.inside_mode} "
        f"normals={cfg.parity_normals} vox={extras['vox_impl']} "
        f"render={extras['render_impl']} deform={extras['deform']} "
        f"device={engine.device}" + (f" chips={chips}" if sharded else "")
    )

    preview = None
    if extras["preview"] is not None and rank == 0:
        # live view (the swap-chain Present analog): open the printed URL
        from dxrvoxelizer_tpu_torch.app.preview import PreviewServer

        port = extras["preview"]
        preview = PreviewServer(port=0 if port < 0 else port)
        print(f"live preview: {preview.url}")

    if extras["interactive"]:
        # hotkey loop (Space/f/s/x/q, the reference's WndProc analog,
        # DXRVoxelizer.cpp:282-299); -frames still bounds it
        from dxrvoxelizer_tpu_torch.app.interactive import run_interactive

        frames = run_interactive(engine, cam, extras["frames"],
                                 orbit=extras["orbit"], preview=preview)
        print(f"rendered {frames} frames")
        if preview is not None:
            preview.close()
        return 0

    if extras["load_grid"]:
        if rank:
            return 0  # one device renders a saved grid
        out = _render_saved_grid(engine, cam, cfg, extras["load_grid"],
                                 extras["render_impl"], extras["out"])
        print(f"rendered saved grid {extras['load_grid']} -> {out}")
        return 0

    base_mesh = engine.pipeline.mesh
    if extras["deform"]:
        base_x = base_mesh.positions_norm[:, :1].cpu().numpy()
    from dxrvoxelizer_tpu_torch.utils.profiling import PassTimers, device_trace

    # -profile DIR: a profiler trace of the frame loop (the PIX-capture
    # analog), written as a Chrome trace into DIR
    trace_ctx = (device_trace(extras["profile"]) if extras["profile"] and not rank
                 else contextlib.nullcontext())
    img = None
    last_fps = 0.0
    with trace_ctx:
        for frame in range(extras["frames"]):
            timer.tick()
            if preview is not None:
                # browser drag-orbit / wheel-zoom (DXRVoxelizer.cpp:301-356)
                preview.apply_camera_inputs(cam)
            if extras["orbit"] and frame:
                cam.orbit(12.0, 0.0)  # slow yaw, the mouse-drag analog
            if extras["deform"]:
                engine.pipeline.mesh = wobbled(base_mesh, base_x, frame)
            engine.update_frame(frame % 3, cam.eye, cam.view_proj)
            img = engine.render(frame % 3)
            if sharded and extras["preview"] is not None:
                # every rank takes part in the gather; rank 0 publishes
                img_full = engine.pipeline.gather_image(img)
            else:
                img_full = img
            if preview is not None and preview.wants_frame():
                preview.publish(img_full)
            if timer.frames_per_second != last_fps:
                last_fps = timer.frames_per_second
                print(f"fps: {last_fps:.1f}")
        engine.sync()
    if sharded and img is not None:
        img = engine.pipeline.gather_image(img)  # the whole image
    if preview is not None:
        preview.close()
    if rank:
        return 0  # rank 0 alone checks, writes and times

    if extras["ab"] and not _ab(engine, cam, cfg, base_mesh):
        return 1

    if img is not None:
        out = extras["out"] or screenshot_name()
        write_png(out, img.cpu().numpy())
        print(f"wrote {out}")
    if extras["save_grid"]:
        grid = engine.voxelize_only()
        save_grid_npy(extras["save_grid"], grid.occupancy().cpu().numpy())
        print(f"wrote {extras['save_grid']}")

    if extras["timings"]:
        # fenced voxelize / raycast passes: per-pass wall clock
        timers = PassTimers(engine.device)
        consts = engine.scene.update_frame(cam.eye, cam.view_proj, cfg.width,
                                           cfg.height)
        for _ in range(3):
            with timers.measure("voxelize"):
                grid = engine.voxelize_only()
            with timers.measure("raycast"):
                engine.render_grid(grid, consts)
        print(f"pass timings (ms): {timers.summary()}")
    return 0
