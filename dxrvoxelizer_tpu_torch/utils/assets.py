"""Asset path resolution.

The canonical scenes (bunny / dragon / TuringBowl) are data shipped with the
reference app (reference: Bin/Assets/*.obj). We do not vendor them; this helper
resolves an asset name against, in order:

1. an absolute / relative path that already exists,
2. ``$DXRVOX_ASSETS``,
3. ``<repo>/assets``.

A copy of ``dxrvoxelizer_tpu/utils/assets.py`` without its fixed
reference-checkout location.
"""

from __future__ import annotations

import os
from pathlib import Path

_REPO_ASSETS = Path(__file__).resolve().parents[2] / "assets"


def asset_search_paths() -> list[Path]:
    paths = []
    env = os.environ.get("DXRVOX_ASSETS")
    if env:
        paths.append(Path(env))
    paths.append(_REPO_ASSETS)
    return paths


def find_asset(name: str) -> Path:
    """Resolve an asset file name (e.g. ``"bunny.obj"``) to an existing path."""
    p = Path(name)
    if p.is_file():
        return p
    # The reference's default mesh name is "Assets/bunny.obj"
    # (reference: DXRVoxelizer/DXRVoxelizer.cpp:36) — strip leading dirs too.
    candidates = [p.name] if p.name != name else [name]
    candidates.insert(0, name)
    for base in asset_search_paths():
        for cand in candidates:
            q = base / cand
            if q.is_file():
                return q
    raise FileNotFoundError(
        f"asset {name!r} not found in: " + ", ".join(str(b) for b in asset_search_paths())
    )
