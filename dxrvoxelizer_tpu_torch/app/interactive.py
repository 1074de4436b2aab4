"""Interactive frame loop with the reference's hotkeys (terminal analog).

Port of ``dxrvoxelizer_tpu/app/interactive.py`` (the port keeps its own copy
of the TTY code). The reference's WndProc handles: Space = pause, F1 =
FPS-in-title toggle, F11 = screenshot, X = switch voxelizer implementation,
Esc = quit (DXRVoxelizer.cpp:282-299). A terminal has no WM_KEYUP, so the
analog reads raw single keys from a non-blocking TTY:

  space  pause/resume            (OnKeyUp VK_SPACE)
  f      toggle FPS printing     (OnKeyUp VK_F1 -> s_showFPS)
  s      screenshot PNG          (OnKeyUp VK_F11 -> m_screenShot)
  x      switch pipeline         (OnKeyUp 'X' -> m_useEZ: swaps voxelize
                                  AND render to the independent alternate
                                  implementation, ez/engine.py toggle_path)
  hjkl   manual camera orbit     (OnMouseMove drag analog)
  + / -  zoom                    (OnMouseWheel analog)
  o      toggle auto-orbit
  q/Esc  quit

Runs headless (no TTY / -frames exhausted) exactly like the batch loop.

With a sharded engine (``-chips N``: every rank runs this loop) the ranks
run in lock step: rank 0 alone reads the terminal and serves the preview,
and each pass of its loop sends the others one message (one
``dist.broadcast_object_list``): the X toggles of the pass and, unless it
is paused, the camera of the frame (eye and view-projection) and whether
rank 0 needs the whole image (a screenshot or a waiting viewer). Every rank
then applies the same toggles and renders the same frame collectively;
rank 0 alone prints, saves and publishes. Rank 0's quit, or the end of
``-frames``, ends every rank's loop on the same frame.
"""

from __future__ import annotations

import select
import sys

from dxrvoxelizer_tpu_torch.ez import Engine
from dxrvoxelizer_tpu_torch.models.camera import OrbitCamera
from dxrvoxelizer_tpu_torch.utils.image import screenshot_name, write_png
from dxrvoxelizer_tpu_torch.utils.timer import StepTimer


class _RawTTY:
    """Non-blocking single-key reads; restores the terminal on exit."""

    def __init__(self):
        self.enabled = sys.stdin.isatty()
        self._old = None

    def __enter__(self):
        if self.enabled:
            import termios
            import tty

            self._old = termios.tcgetattr(sys.stdin.fileno())
            tty.setcbreak(sys.stdin.fileno())
        return self

    def __exit__(self, *exc):
        if self._old is not None:
            import termios

            termios.tcsetattr(
                sys.stdin.fileno(), termios.TCSADRAIN, self._old
            )

    def poll_key(self) -> str | None:
        if not self.enabled:
            return None
        r, _, _ = select.select([sys.stdin], [], [], 0)
        if r:
            return sys.stdin.read(1)
        return None


def _ranks(engine: Engine):
    """A sharded engine's group of several ranks, each its own process,
    else None (a local group renders whole frames in this process)."""
    group = getattr(engine.pipeline, "group", None)
    if group is None or group.world == 1 or group.local:
        return None
    return group


def _send(group, msg) -> None:
    """Rank 0's message of one pass to the other ranks (None: quit)."""
    if group is not None:
        import torch.distributed as dist

        dist.broadcast_object_list([msg], src=0, device=group.device)


def _whole(engine: Engine, img):
    """The whole image from this rank's band (every rank takes part); the
    alternate pipeline renders whole images on every rank."""
    return img if engine.use_alt else engine.pipeline.gather_image(img)


def _follow(engine: Engine, group) -> int:
    """A rank other than 0: apply rank 0's messages until it quits."""
    import torch.distributed as dist

    frame = 0
    while True:
        msg = [None]
        dist.broadcast_object_list(msg, src=0, device=group.device)
        if msg[0] is None:
            break
        toggles, view, whole = msg[0]
        for _ in range(toggles):
            engine.toggle_path()
        if view is None:  # rank 0 is paused
            continue
        engine.update_frame(frame % 3, *view)
        img = engine.render(frame % 3)
        frame += 1
        if whole:
            _whole(engine, img)
    engine.sync()
    return frame


def run_interactive(engine: Engine, cam: OrbitCamera, max_frames: int | None,
                    orbit: bool = True, preview=None) -> int:
    """Drive the engine until quit / max_frames. Returns frames rendered.

    ``preview``: optional :class:`~dxrvoxelizer_tpu_torch.app.preview.
    PreviewServer` — the latest frame is published whenever a viewer is
    waiting for one (the swap-chain Present analog; costs nothing while
    nobody watches). A sharded engine's ranks other than 0 follow rank 0
    (module docstring).
    """
    group = _ranks(engine)
    if group is not None and group.rank:
        return _follow(engine, group)
    toggles = 0  # X presses not yet sent to the other ranks
    timer = StepTimer()
    paused = False  # Space (reference: OnKeyUp VK_SPACE -> m_pausing)
    show_fps = True  # F1 (reference: s_showFPS)
    shot = False  # F11 (reference: m_screenShot)
    frame = 0
    last_fps = 0.0
    img = None

    with _RawTTY() as tty_in:
        while max_frames is None or frame < max_frames:
            key = tty_in.poll_key()
            if key:
                k = key.lower()
                if k == " ":
                    paused = not paused
                    print("paused" if paused else "resumed")
                elif k == "f":
                    show_fps = not show_fps
                elif k == "s":
                    shot = True
                elif k == "x":
                    # full pipeline swap (voxelize AND render), like the
                    # reference's X between Voxelizer and VoxelizerEZ
                    alt = engine.toggle_path()
                    toggles += 1
                    print(
                        "pipeline -> "
                        + ("alt (oracle voxelize + gather render)"
                           if alt else "primary")
                    )
                elif k in ("+", "="):
                    cam.zoom(1.0)  # OnMouseWheel analog
                elif k == "-":
                    cam.zoom(-1.0)
                elif k in "hjkl":
                    # mouse-drag orbit analog: one keypress = a 24-px drag
                    dx = {"h": 24.0, "l": -24.0}.get(k, 0.0)
                    dy = {"k": 24.0, "j": -24.0}.get(k, 0.0)
                    cam.orbit(dx, dy)
                elif k == "o":
                    orbit = not orbit
                    print(f"auto-orbit {'on' if orbit else 'off'}")
                elif k in ("q", "\x1b"):
                    break
            if paused:
                import time

                _send(group, (toggles, None, False))
                toggles = 0
                time.sleep(0.05)  # idle politely until resumed
                timer.tick()  # keep wall time honest while paused
                continue

            timer.tick()
            if preview is not None:
                # browser drag/wheel input (DXRVoxelizer.cpp:301-356)
                preview.apply_camera_inputs(cam)
            if orbit and frame:
                cam.orbit(12.0, 0.0)
            if group is not None:
                # the whole image is gathered only when rank 0 needs it
                show = preview is not None and preview.wants_frame()
                _send(group, (toggles, (cam.eye, cam.view_proj), shot or show))
                toggles = 0
            engine.update_frame(frame % 3, cam.eye, cam.view_proj)
            img = engine.render(frame % 3)
            frame += 1
            if group is None:
                show = preview is not None and preview.wants_frame()
            elif shot or show:
                img = _whole(engine, img)
            if show:
                preview.publish(img)
            if show_fps and timer.frames_per_second != last_fps:
                last_fps = timer.frames_per_second
                print(f"fps: {last_fps:.1f}")
            if shot and img is not None:
                shot = False
                out = screenshot_name()
                write_png(out, img.cpu().numpy())
                print(f"wrote {out}")
    _send(group, None)
    engine.sync()
    return frame
