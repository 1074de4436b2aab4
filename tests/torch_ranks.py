"""Rank workers of the port's multi-rank tests that need a patched app.

Spawned ranks import their worker by name, so it lives in this module, not
in a test file. numpy and the port only.
"""

from __future__ import annotations

import os


class KeyFeed:
    """Scripted key source standing in for the TTY: one key (or None) per
    pass of the interactive loop."""

    def __init__(self, keys):
        self.keys = list(keys)
        self.enabled = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def poll_key(self):
        return self.keys.pop(0) if self.keys else None


def script_interactive(interactive, keys, shots_dir: str,
                       patch=setattr) -> None:
    """Patch the interactive loop's module with ``patch`` (``setattr``, or
    a test's ``monkeypatch.setattr``): its TTY reads ``keys``, and its
    screenshots go to ``shots_dir`` as shot_000.png, shot_001.png, ..."""
    count = iter(range(1 << 30))
    patch(interactive, "_RawTTY", lambda: KeyFeed(keys))
    patch(interactive, "screenshot_name", lambda: os.path.join(
        shots_dir, f"shot_{next(count):03d}.png"))


def interactive_rank(argv: list[str], keys, shots_dir: str) -> None:
    """One rank of ``-chips N -interactive`` (its group initialised), rank
    0 reading ``keys``; a non-zero exit code fails the launch."""
    from dxrvoxelizer_tpu_torch.app import interactive
    from dxrvoxelizer_tpu_torch.app.main import _rank_main

    script_interactive(interactive, keys, shots_dir)
    _rank_main(argv)
