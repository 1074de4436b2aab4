"""Application shell: CLI, frame loop, FPS stats, PNG capture.

Port of ``dxrvoxelizer_tpu/app/main.py`` for the flags of the parity
frame: the reference's ``-mesh <file> [x y z scale]``, ``-warp`` (here:
the CPU device) and ``-inside raystab`` (the reference's own inside rule),
plus ``-normals -grid -width -height -frames -out -hq -fast -quality
-noorbit -voximpl -deform``. A frame loop orbits the camera (the
mouse-drag analog), prints FPS at 1 Hz, and writes the last frame as a PNG.
``-deform`` wobbles the vertices along their normals every frame, so every
frame re-bins and re-voxelizes the mesh (the deforming configuration).

    python -m dxrvoxelizer_tpu_torch.app -mesh bunny.obj -frames 8 -out f.png
    python -m dxrvoxelizer_tpu_torch.app -mesh bunny.obj -grid 256 -deform
    python -m dxrvoxelizer_tpu_torch.app -mesh bunny.obj -inside raystab
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from dxrvoxelizer_tpu_torch.ez import Engine
from dxrvoxelizer_tpu_torch.models.camera import OrbitCamera
from dxrvoxelizer_tpu_torch.utils.config import parse_args
from dxrvoxelizer_tpu_torch.utils.device import select_device
from dxrvoxelizer_tpu_torch.utils.image import screenshot_name, write_png
from dxrvoxelizer_tpu_torch.utils.timer import StepTimer


def _parse_extras(argv: list[str]) -> dict:
    """Extension flags (reference-style prefixes)."""
    out = {"frames": 8, "out": None, "orbit": True, "vox_impl": "auto",
           "deform": False}
    i = 0
    while i < len(argv):
        a = argv[i]
        key = a[1:].lower() if a[:1] in "-/" else ""
        if key == "frames" and i + 1 < len(argv):
            out["frames"] = int(argv[i + 1])
        elif key == "out" and i + 1 < len(argv):
            out["out"] = argv[i + 1]
        elif key == "noorbit":
            out["orbit"] = False
        elif key == "voximpl" and i + 1 < len(argv):
            out["vox_impl"] = argv[i + 1]
        elif key == "deform":
            out["deform"] = True
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


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    cfg = parse_args(argv)
    extras = _parse_extras(argv)
    # CUDA unless -warp/-cpu asks for the CPU; no silent fallback
    device = select_device("cpu" if cfg.backend == "cpu" else "default")

    engine = Engine(cfg, device, vox_impl=extras["vox_impl"],
                    deforming=extras["deform"])
    cam = OrbitCamera(cfg.width, cfg.height)
    timer = StepTimer()
    print(
        f"dxrvoxelizer_tpu_torch: {cfg.mesh} "
        f"({engine.scene.buffers.num_triangles} tris) grid={cfg.grid_size}^3 "
        f"{cfg.width}x{cfg.height} ss={cfg.render_ss} mode={cfg.inside_mode} "
        f"normals={cfg.parity_normals} vox={extras['vox_impl']} "
        f"deform={extras['deform']} device={device}"
    )
    base_mesh = engine.pipeline.mesh
    if extras["deform"]:
        base_x = base_mesh.positions_norm[:, :1].cpu().numpy()

    img = None
    last_fps = 0.0
    for frame in range(extras["frames"]):
        timer.tick()
        if extras["orbit"] and frame:
            cam.orbit(12.0, 0.0)  # slow yaw, the mouse-drag analog
        if extras["deform"]:
            engine.pipeline.mesh = wobbled(base_mesh, base_x, frame)
        engine.update_frame(frame % 3, cam.eye, cam.view_proj)
        img = engine.render(frame % 3)
        if timer.frames_per_second != last_fps:
            last_fps = timer.frames_per_second
            print(f"fps: {last_fps:.1f}")
    engine.sync()

    if img is not None:
        out = extras["out"] or screenshot_name()
        write_png(out, img.cpu().numpy())
        print(f"wrote {out}")
    return 0
