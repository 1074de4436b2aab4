"""Application shell: CLI, frame loop, FPS stats, PNG capture.

Port of ``dxrvoxelizer_tpu/app/main.py`` for the flags of the static
parity frame: the reference's ``-mesh <file> [x y z scale]`` and ``-warp``
(here: the CPU device), plus ``-grid -width -height -frames -out -hq -fast
-quality -noorbit``. A frame loop orbits the camera (the mouse-drag analog),
prints FPS at 1 Hz, and writes the last frame as a PNG.

    python -m dxrvoxelizer_tpu_torch.app -mesh bunny.obj -frames 8 -out f.png
"""

from __future__ import annotations

import sys

from dxrvoxelizer_tpu_torch.ez import Engine
from dxrvoxelizer_tpu_torch.models.camera import OrbitCamera
from dxrvoxelizer_tpu_torch.utils.config import parse_args
from dxrvoxelizer_tpu_torch.utils.device import select_device
from dxrvoxelizer_tpu_torch.utils.image import screenshot_name, write_png
from dxrvoxelizer_tpu_torch.utils.timer import StepTimer


def _parse_extras(argv: list[str]) -> dict:
    """Extension flags (reference-style prefixes)."""
    out = {"frames": 8, "out": None, "orbit": True}
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
        i += 1
    return out


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    cfg = parse_args(argv)
    extras = _parse_extras(argv)
    # CUDA unless -warp/-cpu asks for the CPU; no silent fallback
    device = select_device("cpu" if cfg.backend == "cpu" else "default")

    engine = Engine(cfg, device)
    cam = OrbitCamera(cfg.width, cfg.height)
    timer = StepTimer()
    print(
        f"dxrvoxelizer_tpu_torch: {cfg.mesh} "
        f"({engine.scene.buffers.num_triangles} tris) grid={cfg.grid_size}^3 "
        f"{cfg.width}x{cfg.height} ss={cfg.render_ss} device={device}"
    )

    img = None
    last_fps = 0.0
    for frame in range(extras["frames"]):
        timer.tick()
        if extras["orbit"] and frame:
            cam.orbit(12.0, 0.0)  # slow yaw, the mouse-drag analog
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
