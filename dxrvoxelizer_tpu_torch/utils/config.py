"""Configuration + CLI surface matching the reference app.

A copy of ``dxrvoxelizer_tpu/utils/config.py``: the JAX package cannot be
imported without JAX, so the port carries its own numpy-only helpers.

Compile-time constants in the reference: GRID_SIZE 64 (Content/Voxelizer.cpp:8),
NUM_SAMPLES 128 / NUM_LIGHT_SAMPLES 32 / ABSORPTION 1.0 / ZERO_THRESHOLD 0.01
(Content/Shaders/PSRayCast.hlsl:7-11), THRESHOLD 0.12 (DXRVoxelizer.hlsl:5),
CLEAR_COLOR 0.0,0.2,0.4 (Content/SharedConst.h:8), 1280x720 (Main.cpp:17),
default mesh Assets/bunny.obj + posScale (0,0,0,1) (DXRVoxelizer.cpp:36-37).

Runtime CLI in the reference: ``-warp | -uma | -mesh <file> [x y z scale]``
with ``-``/``/`` prefixes, case-insensitive (DXRVoxelizer.cpp:363-408). We map
``-warp`` (and ``-cpu``) to the CPU device (the reference's
software-rasterizer fallback analog) and accept both prefix styles.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class VoxelizerConfig:
    grid_size: int = 64
    width: int = 1280
    height: int = 720
    mesh: str = "bunny.obj"
    pos_scale: tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    num_samples: int = 128
    num_light_samples: int = 32
    absorption: float = 1.0
    zero_threshold: float = 0.01
    inside_threshold: float = 0.12
    clear_color: tuple[float, float, float] = (0.0, 0.2, 0.4)
    light_pt: tuple[float, float, float] = (-10.0, 45.0, -75.0)  # Voxelizer.cpp:93
    # inside-test mode: "parity" (axis-parity fill; watertight, the
    # default per BASELINE.json) or "raystab" (the reference's radial
    # back-face rule, for reference-parity validation).
    inside_mode: str = "parity"
    backend: str = "default"  # "default" (CUDA) | "cpu" (the -warp analog)
    # texture emulation switches (Content/SharedConst.h:5-6): show_mip
    # renders from mip level N of the grid; use_mutex stores/samples a plain
    # float density channel instead of the R10G10B10A2 alpha
    show_mip: int = 0
    use_mutex: bool = False
    # shear-warp intermediate resolution cap (128 = speed, up to 512 =
    # sharper hi-res renders; the -quality flag raises it)
    intermediate_cap: int = 128
    # shear-warp z-supersampling factor: ss sub-slabs per voxel slab,
    # z-LERPed so every sample is fully trilinear like the reference's
    # 128-step march (PSRayCast.hlsl:117-145). DEFAULT 2 (the -hq mode,
    # which also selects the reference-step light sweep): the reference's
    # quality IS its default, and the measured cost is ~0.2 ms on the
    # 16.7 ms 1080p frame budget for a 4x accuracy win (p99 u8 error
    # 9-15 vs 34-41 — docs/RENDER_QUALITY.md). -fast restores ss=1 +
    # the per-slab recurrence light sweep (the speed mode).
    render_ss: int = 2
    # the reference's _POINT_LIGHT_ compile branch (PSRayCast.hlsl:151-154):
    # per-sample light direction toward the light POINT instead of the
    # directional default
    point_light: bool = False
    # parity mode with the reference's float4(Normal, 1.0) grid content
    # (DXRVoxelizer.hlsl:83-84): radial first-hit normals gated by the
    # parity occupancy bit (-normals flag; extra raystab-query cost)
    parity_normals: bool = False
    # persist built ray-stab accels on disk keyed by (geometry, grid,
    # ladder, backend) — the precompiled-AS analog (utils/accel_cache.py);
    # -noaccelcache disables
    accel_cache: bool = True
    # deforming raystab: per-vertex displacement bound (normalized space)
    # the per-frame accel REFIT absorbs (ops/raystab_refit.py, the DXR
    # AS-update analog). The app's -deform wobble peaks at 0.03; the
    # default leaves margin. Keep it TIGHT: padded-cone candidate tables
    # grow superlinearly with the pad (64^3 dragon slot rows: 0.84M at
    # 0.01, 1.85M at 0.03, 3.44M at 0.05 vs 0.47M static), and the refit
    # regathers every slot each frame. -deformpad X overrides.
    deform_pad: float = 0.035
    # deformation direction contract for the raystab refit: "normals"
    # (the engine's -deform wobble moves each vertex along its normal —
    # padded candidate cones become CAPSULES, several-fold smaller) or
    # "any" (isotropic ball bound, any displacement <= deform_pad).
    # -deformdirs any opts out for off-axis API deformations.
    deform_dirs: str = "normals"
    # midpoint-subdivision levels applied at load (4x tris per level) — the
    # hi-poly bench configs (BASELINE.md: the 871k-tri full Stanford dragon
    # is not shipped; the 100k decimation at -subdiv 1 is the 400k-tri
    # equivalent workload over an identical surface)
    subdiv: int = 0

    def replace(self, **kw) -> "VoxelizerConfig":
        return dataclasses.replace(self, **kw)


def parse_args(argv: list[str]) -> VoxelizerConfig:
    """Parse reference-style CLI flags plus this build's extensions."""
    cfg = VoxelizerConfig()
    kw: dict = {}

    def is_flag(a: str, name: str) -> bool:
        return len(a) > 1 and a[0] in "-/" and a[1:].lower() == name

    def has_value(i: int) -> bool:
        if i + 1 >= len(argv):
            return False
        nxt = argv[i + 1]
        if nxt.startswith("/"):
            return False
        # a leading '-' only counts as a value if numeric (DXRVoxelizer.cpp:387-391)
        if nxt.startswith("-") and not (len(nxt) > 1 and (nxt[1].isdigit() or nxt[1] == ".")):
            return False
        return True

    i = 1 if argv and argv[0].endswith(".py") else 0
    n = len(argv)
    while i < n:
        a = argv[i]
        if is_flag(a, "warp") or is_flag(a, "cpu"):
            kw["backend"] = "cpu"
        elif is_flag(a, "uma"):
            pass  # adapter preference: meaningless here; accepted for parity
        elif is_flag(a, "mesh"):
            if has_value(i):
                i += 1
                kw["mesh"] = argv[i]
            ps = list(cfg.pos_scale)
            for j in range(4):
                if has_value(i):
                    i += 1
                    ps[j] = float(argv[i])
                else:
                    break
            kw["pos_scale"] = tuple(ps)
        elif is_flag(a, "grid"):
            if has_value(i):
                i += 1
                kw["grid_size"] = int(argv[i])
        elif is_flag(a, "width"):
            if has_value(i):
                i += 1
                kw["width"] = int(argv[i])
        elif is_flag(a, "height"):
            if has_value(i):
                i += 1
                kw["height"] = int(argv[i])
        elif is_flag(a, "inside"):
            if has_value(i):
                i += 1
                kw["inside_mode"] = argv[i]
        elif is_flag(a, "showmip"):
            if has_value(i):
                i += 1
                kw["show_mip"] = int(argv[i])
        elif is_flag(a, "subdiv"):
            if has_value(i):
                i += 1
                kw["subdiv"] = int(argv[i])
        elif is_flag(a, "usemutex"):
            kw["use_mutex"] = True
        elif is_flag(a, "noaccelcache"):
            kw["accel_cache"] = False
        elif is_flag(a, "pointlight"):
            kw["point_light"] = True
        elif is_flag(a, "normals"):
            kw["parity_normals"] = True
        elif is_flag(a, "quality"):
            kw["intermediate_cap"] = int(argv[i + 1]) if has_value(i) else 512
            if has_value(i):
                i += 1
        elif is_flag(a, "deformpad"):
            if has_value(i):
                i += 1
                kw["deform_pad"] = float(argv[i])
        elif is_flag(a, "deformdirs"):
            if has_value(i):
                i += 1
                kw["deform_dirs"] = argv[i].lower()
        elif is_flag(a, "hq"):
            # high-fidelity render: 2x z-supersampling (optionally -hq N;
            # the default since round 4 — kept as an explicit override)
            kw["render_ss"] = int(argv[i + 1]) if has_value(i) else 2
            if has_value(i):
                i += 1
        elif is_flag(a, "fast"):
            # speed mode: no z-supersampling + the per-slab recurrence
            # light sweep (the pre-round-4 default)
            kw["render_ss"] = 1
        i += 1
    return cfg.replace(**kw)
