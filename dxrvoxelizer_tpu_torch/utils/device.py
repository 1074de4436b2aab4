"""Device selection (the counterpart of ``dxrvoxelizer_tpu/utils/backend.py``).

The reference tries discrete GPU -> UMA -> WARP software rasterizer at device
creation (DXRVoxelizer.cpp:89-128, 590-636). The port has no silent ladder:
the default is the CUDA device, and the CPU is used only when asked for
explicitly (``-warp`` / ``-cpu``, DXRVoxelizer.cpp:392). A machine without
CUDA raises instead of quietly rendering on the CPU, so no CPU number is ever
mistaken for a GPU one.
"""

from __future__ import annotations

import torch


def select_device(prefer: str = "default") -> torch.device:
    """``"default"`` -> the current CUDA device; ``"cpu"`` -> the CPU.

    Raises ``RuntimeError`` when CUDA is requested but unavailable.
    """
    if prefer == "cpu":
        return torch.device("cpu")
    if prefer != "default":
        raise ValueError(f"unknown device preference {prefer!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass -warp (or -cpu) to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def config_device(cfg) -> torch.device:
    """The device a configuration runs on, as the app picks it: the CPU for
    ``-warp``/``-cpu`` (``cfg.backend == "cpu"``), else the CUDA device
    (raises without one)."""
    return select_device("cpu" if cfg.backend == "cpu" else "default")
