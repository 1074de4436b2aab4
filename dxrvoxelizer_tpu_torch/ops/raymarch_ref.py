"""Shader constants of the reference ray-marcher (PSRayCast.hlsl).

The constants of ``dxrvoxelizer_tpu/ops/raymarch_ref.py``; the shader-exact
renderer itself waits for a later slice of the port (ROADMAP.md).
"""

from __future__ import annotations

import math

import numpy as np

ABSORPTION = 1.0  # PSRayCast.hlsl:9
ZERO_THRESHOLD = 0.01  # PSRayCast.hlsl:10
MAX_DIST = 2.0 * math.sqrt(3.0)  # PSRayCast.hlsl:33
TEX_SCALE = np.array([0.5, -0.5, 0.5], dtype=np.float32)  # PSRayCast.hlsl:137
