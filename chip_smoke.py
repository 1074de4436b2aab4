"""Smoke run of the PyTorch + CUDA build (``dxrvoxelizer_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (sm_90a) and
the CUDA toolkit. Phases, one line each:

1. the card (``nvidia-smi`` name and power limit) and the build of every
   kernel in ``dxrvoxelizer_tpu_torch/csrc`` from source, and of the native
   host tier (``utils/_native``, g++);
2. the app's default frame, as a user runs it: 64^3 parity voxelize + ``-hq``
   shear-warp render at 1280x720, 4 orbiting frames, on a procedural
   81,920-triangle icosphere (``tests/meshes.py``) written to an OBJ at the
   world footprint of the reference's default bunny (about 8 units tall,
   centred at the camera's focus); every kernel of that path must have
   launched;
3. one ``-fast`` frame (no z-supersampling);
3b. before any other heavy phase: the first ``-inside raystab`` frame
    (accel build + frame) from a cold voxel->cell ray table, then the first
    ``-normals`` frame, and the 64^3 parity, ray-stab and ``-normals``
    frames timed in turns (each a median as in phase 5): the frame times
    reported for these three paths;
4. each kernel against its plain torch version on the card, at the shapes
   the main path gives it (the binned parity kernel bit for bit at the main
   path's settings and every layout of its sweep, on the 64^3 frame's bins,
   the icosphere at 256^3, a box with faces on voxel centres at 32, 64 and
   256^3, two needle soups at 64^3 and the brute-force path at 64^3; the
   march at ss = 1 and 2; the fused screen resolve's coordinates and hit
   mask bit for bit against ``screen_coords`` and its image against
   ``resolve_plain``, on 4 orbit cameras that set swap and flip on and
   off), and the whole frame against the plain path and against the CPU on
   a small input;
5. medians of 5 runs, timed with CUDA events around 10 back-to-back calls,
   of each kernel, its plain version, and the whole frame; the device time
   per call (profiler) of the march, the resolve and its yardstick
   ``grid_sample``; the resolve wrapper's host time per call beside one
   elementwise torch op's; the march set-up's host time per frame and its
   ring sizing's; then a profiler window of 5 frames for the device time
   per kernel and the idle share;
5c. the binned parity kernel at the 64^3 frame's bins: the rows it walks
    and the (column, row) pairs it tests against those the function needs
    and those the parent kernel tested; every layout of its sweep (a
    cluster of 1 to 16 blocks per tile, blocks per tile with device-memory
    atomics, at 256 or 512 threads; the parent's every-column layout, and
    the parent's work, every row of the capacity): CUDA-event ms
    and profiler device us per call, and with the L2 cache flushed before
    each call;
5b. the march at the 64^3 frame's inputs across intermediate sizes M = 64,
    128, 256, 512 and sub-slab counts KS = 64, 128 (ss = 1, 2): CUDA-event
    ms and profiler device us per call;
6. the hi-res app frame: ``-grid 256``, 4 frames, on the 327,680-triangle
   icosphere at the same footprint (the stand-in for the hi-res dragon):
   the work-queue kernel must launch once per frame, the binned one never;
7. the same with ``-deform``: the mesh wobbles and is re-binned on the
   device every frame, and the work-queue kernel launches every frame;
8. the deforming voxelizer's per-frame call under
   ``torch.cuda.set_sync_debug_mode("error")``: no host sync;
9. the work-queue kernel against its plain version, bit for bit, at 128^3,
   256^3 and 512^3 on the icosphere and on a box with faces on voxel
   centres, and against the binned kernel's words there; against the
   counting oracle at 128^3; on queues with span overflow (at 256^3, 128^3,
   and 512^3 with a box's faces appended to every tile); on two deformed
   frames; every layout and block size of its sweep (phase 11b) on each;
10. the 256^3 ``-hq`` frame at 1280x720 against the plain path, and the
    march and resolve against their plain versions at that frame's inputs
    (the resolve on the 4 orbit cameras again);
11. times of the work-queue kernel (256^3, 512^3), its plain version, the
    binned kernel on the same 256^3 mesh, the deforming voxelizer's call,
    the march and resolve at the 256^3 frame's inputs (with plain versions
    and bounds), and the whole static and deforming 256^3 frames; a
    profiler window of each 256^3 frame; the work-queue kernel's device time
    per call and its (column, row) pairs tested against those the function
    needs (the column centres in each triangle's bounding box);
11b. the work-queue kernel's sweep at 256^3 and 512^3: one block per tile
    run (the main path) at 128, 256 and 512 threads, one block per chunk
    with atomics at 128 and 256, and the main layout without spans (every
    row against its whole tile) and with empty spans (no pair tested: a
    timing probe): CUDA-event ms and profiler device us per call, and the
    main layout's device us per call with the L2 cache flushed before each
    call;
12. the app's ``-inside raystab`` frame (the reference's own inside rule,
    the gen-6 accel) at 64^3, ``-hq``, 1280x720, 4 frames, on the 81,920-
    triangle icosphere: the fold + extraction kernel must launch every frame
    and the parity kernels never;
13. the app's ``-normals`` frame at the same settings: the binned parity
    kernel and the fold + extraction kernel (rule "hit") every frame;
14. the fold + extraction kernel against its plain version bit for bit on
    (t, id, ns), both rules, on the 64^3 icosphere, the box with faces on
    voxel centres and a near-origin soup (the shared stream and its merge);
    the fold-only kernel against the plain fold; the whole query against
    the radial oracle at 64^3 on a 5,120-triangle icosphere; the ray-stab
    and ``-normals`` frames against the plain path;
14b. the fold + extraction kernel, at every setting of its sweep, and the
    fold alone against the plain fold on synthetic strips
    (``tests/torch_cases.py``): equal t under different ids across chunk and
    sub-chunk boundaries (the lowest id must win), a strip of 9 chunks of
    which some are skipped and some not, and all-padding strips; both rules;
15. times of both ray-stab kernels at the 64^3 frame's tables (plain
    versions and bounds), the accel build (from a cold ray table, then
    warm), the three 64^3 frames in turns again late in the run (how far
    host time drifted since phase 3b), the plain ray-stab and ``-normals``
    frames, and a profiler window of each ray-stab frame; the fold +
    extraction kernel's device time per call, and its (ray, candidate) pairs:
    tested, those past the sign test of the three dot products (the only ones
    that divide), and the (warp, candidate) steps holding one;
15b. the fold + extraction kernel's sweep at the 64^3 frame's tables: 1, 2
    and 4 groups of 128 threads per strip, 1, 2 and 3 ring stages, with and
    without the deferred division: CUDA-event ms and profiler device us per
    call; and, with the L2 cache flushed before each call (as in a frame,
    where the march evicts the accel's tables), the main settings, each ring
    depth and the fold alone;
16. the core-tier gen-1 ray-stab path (``build_raystab_accel`` +
    ``voxelize(mode="raystab", accel=...)`` + ``render``, the README's
    persistent-accel API) on the 64^3 icosphere buffers: the build's host
    and device halves (from a cold ray table, then warm), 4 orbiting frames
    at 1280x720 ``-hq`` in which the Moller-Trumbore kernel must launch once
    per query (twice with overflow triangles) and the parity and gen-6
    kernels never; the kernel against its plain version bit for bit on
    (t, id), at the main path's settings and every setting of its sweep, on
    that icosphere, the box with faces on voxel centres, the near-origin
    soup (the overflow stream over its 300 rows) and the stress stream of
    ``tests/torch_cases.py`` at every slice width (det near 1e-10, u and v
    underflowing to -0.0, u + v within a few ulp of 1, t ties and bounds);
    the query against the Moller-Trumbore oracle at 64^3 on a 5,120-triangle
    icosphere, and the frame against the plain path; times of the kernel,
    its plain version and the frame, and a profiler window of the frame;
    the real (ray, candidate) pairs that reach each of the kernel's tests,
    which its bound counts;
16b. the Moller-Trumbore kernel's sweep on the 64^3 gen-1 accel sliced at
    32, 64 and 128 lanes: 128 and 256 threads per block, with and without
    the deferred division, rows read from device memory or staged through
    shared memory, each bit for bit against the plain version: CUDA-event ms
    and profiler device us per call, the main settings with the L2 flushed,
    and each width's slices and lane slots.
18. gen-7 at 256^3 (build by stage, the query against its plain version,
    gen-6 and the radial oracle) and the refitters: refitted streams hold
    the frame's fused matrix and the rest build's row ids, and the fold
    kernels read each candidate row through its id; those kernels (the main
    path's and a setting of the sweep) against their plain versions
    on the rows each stream stands for, bit for bit, on gen-7 refits at
    256^3 of the 327,680-triangle icosphere and of the cells' 100,000-
    triangle torus, and on a gen-6 refit at 64^3 of the icosphere with the
    near-origin soup (both streams); the fold's device time on materialised
    rows against row ids, warm and with the L2 flushed; the candidate rows
    and the bytes a refit no longer writes per frame; a refit + query under
    ``set_sync_debug_mode("error")``.

20. the render variants and the rest of the app shell, on the 64^3
    icosphere frame: through the app, ``-renderimpl gather`` (the gather
    march and light volume kernels once per frame), ``-showmip 1`` and
    ``2`` with and without ``-usemutex`` (the 16^3 mip level's ``-hq``
    light step spans less than one slab, d0 = 0: the light volume kernel
    once per frame), ``-pointlight`` (the light outside: the perspective
    sweep X.5 once per frame) and with ``-renderimpl gather``,
    ``-renderimpl ref`` at
    320x180, ``-ab`` (exit 0), ``-savegrid`` then ``-loadgrid``,
    ``-timings``, ``-profile`` (the trace file exists), ``-interactive``
    and ``-preview``; through the Engine, the X-key alternate frames (the
    counting oracle + the gather renderer; the Engine built as the JAX
    package builds it, ``Engine(cfg)``, on the card) and the point light
    inside the volume (the light volume kernel); both kernels against
    their plain versions at 64^3 and 256^3, on the frame's grid, a random
    grid and a 4-level alpha grid, every case of the card tests: the light
    volume directional, point and inside; the march (its ray set-up fused
    in) against gather_rays + the plain march from the frame's camera over
    each light volume, from a camera inside the box and along an axis, and
    on a band of rows; their CUDA-event ms, profiler device us, wrapper
    host us, plain ms, bounds (counted from the live samples; the march's
    also under the formula of the kernel it replaced, which read its rays)
    and the ``grid_sample`` yardstick over the same sample points; the step
    loads that batches of K = 1, 2, 4, 8 steps issue past a break (in-box
    steps after the stop step, to the end of its batch); the gather frame
    against the warp ``-hq`` frame at 64^3 and 256^3 (frame ms in turns,
    device busy, idle share and ops per frame), render-only times with the
    light volume computed and passed in, and both images against
    ``raymarch_ref`` at 64^3, 1280x720 (mean, p99, max).
21. the multi-device frames, batch datagen and the native tier: a NCCL
    group of one rank runs ``ShardedFramePipeline`` at 1280x720 (64^3
    ``-hq``, 256^3 parity, 256^3 gen-7 ray-stab, 64^3 gen-6 ray-stab, 64^3
    gather, 64^3 ``-pointlight``), the merges on their kernels (gen-7 X.6,
    gen-6 X.10, the parity frames' words X.7), each image bit-identical to
    ``FramePipeline``'s, with frame ms, device busy, ops
    per frame and the all_gather's bytes and ms; the rank bodies of world 2
    and 4 in one process, every tile group of the work-queue kernel, band
    of the resolve and strip slice of the fold against its plain version
    and the whole call, bit for bit; ``-chips 2`` raising on the one-card
    machine; datagen at 128^3 on 16 procedural meshes through
    ``-impl queue`` and ``pallas`` (meshes per second); the native tier's
    g++ builds (phase 1), OBJ parse, ray table and the gen-6 256^3 pack
    walk against their Python versions.
22. the port's benchmark, ``python -m dxrvoxelizer_tpu_torch.bench``, as a
    subprocess on the card (its entries at 1920x1080, 512^3, 1024^3 and on
    the 400k-triangle mesh, each output held against its plain version
    before it is timed): its JSON line and wall time; it must exit 0 with
    every key of ``bench.expected_keys()``, no ``failed_`` key, launch
    the parity, queue, march, resolve and fold + extraction kernels in its
    timed calls, and report its largest error against the plain versions
    for the queue kernel, the march and the resolve (folded into the
    kernels' ``max_abs_err`` below).
22b. the light recurrences' kernel (``csrc/light_sweep.cu``): X.3 (the
    ``-hq`` reference step) and X.4 (the ``-fast`` per-slab sweep) against
    their plain versions at 32, 64, 128, 160 and 256^3 for lights of every
    major axis and sign with the reference step's windows d0 = 1..13 and
    each cell's own light, X.5 (the ``-pointlight`` perspective sweep) for
    point lights of every major axis and side, far, near the far face and
    off-axis, and all three on the 64^3 and 256^3 frames' densities and
    lights (within 1e-5); at those frames' inputs their ms, device us, us
    per step and roofline share, the bounds and the plain versions' times,
    and with ``--parent TREE`` the kernel of TREE's
    ``csrc/light_sweep.cu`` in turns with this tree's, 10 pairs, the first
    side alternating (X.5: "no parent kernel" where TREE has none);
    the app's ``-fast``
    frames, in which X.4 must launch once per frame and X.3 never; the
    app's ``-pointlight`` frames at 64^3 and 256^3, in which X.5 must
    launch once per frame and X.3 and X.4 never, and those frames' device
    ops, busy ms and ms through ``FramePipeline`` with the kernel and with
    the point sweep's plain version;
22c. the glue kernels (``csrc/grid.cu``, ``csrc/refit_rows.cu``): X.6
    (the ray-stab grid's untiling, R10G10B10A2 rounding and packing), X.7
    (the words' unpacking to density), X.8 (the march's slab stack), X.9
    (the refit's per-triangle rows) and X.10 (gen-6's stream merge with
    X.6's rounding and packing). Each cell's frames, driven as
    ``benchmark/run.py`` drives them, and the app's 64^3 ``-inside
    raystab`` frame, with the launch counts set to 0 before and read after
    (B: X.6, X.8 and X.9 once a frame; A and C: X.7 and X.8; the 64^3
    ray-stab frame X.10 and X.8); each kernel against its plain version
    with == (NaN at the same places) and bit for bit on those frames'
    grids, accels, densities and lights, on the tie set of
    ``tests/torch_cases.quantize_cases``, with the rounding off, X.8 in all
    six (axis, flip) pairs and on a strided density, and again at sizes
    8, 13, 40, 64 and 256 on a contiguous density, the strided alpha and a
    density one float off a 16-byte boundary (each of its paths), X.9 at
    B's refit (int64 and int32 triangles) and on the 64^3 and 256^3
    icospheres, X.10 on the
    64^3 icosphere's gen-6 accel and on it with the near-origin soup (both
    streams), gated, on the sharded frames' packed pieces and without the
    near-origin stream; at each path's inputs each kernel's ms, device us,
    bound, plain ms and launches a frame, and for X.8 the time of
    ``torch.stack(...).contiguous()``; X.8 by marching axis at 64^3 and
    256^3 (device us, bound, share, the stack call's device us), X.9 at
    B's refit and on the 256^3 icosphere by index width;
23. the benchmark's cells (``BENCHMARK.json``), each as a subprocess,
    ``python3 benchmark/run.py --workload <cell> --seed 0 --frames 20``:
    each must exit 0 with ``correct`` true, every metric the file lists for
    the cell measured, and every ``_roofline_share`` at most 1.0; or exit 1
    for the runner's launch gate alone, naming exactly the glue kernels of
    phase 22c that the cell launches and the file does not list yet. Their
    launches are not counted in the kernels line.

Then one JSON line with every kernel's launches on the main paths (the
64^3, 256^3, 256^3 ``-deform``, 64^3 ``-inside raystab`` and 64^3
``-normals`` app runs, the core-tier gen-1 frames, phase 20's runs,
phase 21's sharded frames and datagen, phase 22's benchmark, phase
22b's ``-fast`` and ``-pointlight`` app runs and phase 22c's cell frames,
each counted from zero; the fold-only kernel is on no main path, as in the
JAX package, and shows 0), its largest difference from its plain version
(over every comparison above), and, at the inputs of the main path it
belongs to (the 64^3 frame for the binned kernel, the march, the resolve,
the render variants' and the light recurrences' kernels; the 256^3 frame for the work-queue
kernel; the 64^3 ray-stab frame's tables for the gen-6 ray-stab kernels;
the gen-1 accel's slices for the Moller-Trumbore kernel; cell B's frame
for X.6 and X.9, cell C's for X.7 and X.8, the 64^3 ray-stab frame's for
X.10), its time, its
plain version's time, its bound and, where one PyTorch call computes the
same function (or the gathers alone, ``grid_sample``), that call's time.
The line before it gives the whole run's seconds. Any failure raises and
exits non-zero. The last line is the JSON result.
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import re
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from pathlib import Path

import numpy as np

# the timing helpers the port's benchmark uses (run from the repository root:
# an empty directory has no package, and the script fails there)
from dxrvoxelizer_tpu_torch.bench import (
    INNER,
    PROFILE_FRAMES,
    REPS,
    WORLD_CENTER,  # the icospheres at the reference bunny's world footprint
    WORLD_SCALE,
    cuda_ms,
    device_us,
    profile_frames,
    torus_mesh,
    write_obj,
)

FRAMES = 4
GRID = 64
GRID_HI = 256
# kernel-vs-plain bounds (absolute): the march's is the JAX package's own
# kernel bound (tests/test_march_pallas.py); the resolve's absorbs the
# march's ulp-level noise through the sqrt tone curve; the frame's is the
# tet-golden bound (tests/test_goldens.py)
TOL_MARCH = 2e-6
TOL_RESOLVE = 1e-5
TOL_FRAME = 2e-3
# orbit yaws (pixels dragged at 1280 wide: a quarter turn each) of the
# resolve checks; on the default camera they set (flip, swap) = (F, T),
# (T, F), (T, T), (F, F)
ORBIT_YAWS = (0.0, 320.0, 640.0, 960.0)
# published peaks of one H100 SXM at 700 W (NVIDIA data sheet, dense rates)
PEAK_FP32 = 67e12  # FP32 operations per second outside the tensor cores
# (an FMA counts as two: kernels whose chains cannot fuse run at half this)
PEAK_BYTES = 3.35e12  # device memory bytes per second
# FP32 operations the kernels must do, counted from their sources: per
# (column, triangle) pair inside the triangle's bounding box the four affine
# forms of the parity kernels; per
# live (pixel, sub-slab) step of the march (taps, z-mix at ss = 2, warp,
# compositing); per hit pixel of the resolve (taps, two bilinear samples,
# composite); per pixel of the resolve, the screen mapping it now computes
# itself (csrc/screen_warp.cu; adds, subtractions, multiplications,
# divisions and the square root; compares, abs, min/max and selects not
# counted): the pixel centre 2, the homogeneous transform 16, the
# perspective divide 3, the direction 3, its length 6 and normalisation 3,
# the three slab tests 18, the tex-space direction 3, the reference-plane
# point 6, the two reciprocals 2 and the intermediate coordinates 8 = 70
PARITY_OPS_PER_PAIR = 16
MARCH_OPS_PER_STEP = {1: 39, 2: 64}
RESOLVE_OPS_PER_HIT = 60
SCREEN_MAP_OPS_PER_PIXEL = 70
# per real (ray, candidate) pair of the ray-stab kernels: radial_hit's three
# dot products (9 mul, 6 add), den (2 add), the division and the subtraction
# (compares and selects not counted, as for the parity kernels)
RAYSTAB_OPS_PER_PAIR = 19
# per real (ray, candidate) pair of the Moller-Trumbore kernel, by the test
# at which it leaves (csrc/raystab_mt.cu): every pair computes p = d x e2
# (6 mul, 3 sub), det = e1 . p (5) and |det| > eps (2); past that test,
# 1 / det, the origin's 3 subtractions, u = (tv . p) * inv (6) and u >= 0;
# past it, q = tv x e1 (9), v = (d . q) * inv (6) and v >= 0; past it,
# u + v and its compare; past it, t = (e2 . q) * inv (6) and t's two
# compares; a hit, the two compares of the (t, id) minimum. A hit costs 55.
# Compares are counted here, unlike for the parity and radial kernels.
MT_OPS_BY_STAGE = (16, 11, 16, 2, 8, 2)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _load_script(root: Path, name: str):
    """``scripts/<name>.py`` by path (the directory is not a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"dxv_script_{name}", root / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_test_module(root: Path, name: str):
    """``tests/<name>.py`` by path: an installed package named ``tests``
    would shadow the repository's directory of that name."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"dxv_test_{name}", root / "tests" / f"{name}.py"
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """Least time (ms) for the work: bytes over the memory rate or FP32
    operations over the peak rate, whichever is larger."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_FP32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def real_rows(coef) -> int:
    """Coefficient rows that hold a triangle (padding rows are all zero)."""
    return int((coef != 0).any(-1).sum())


def bbox_pairs(torch, verts, tris, n: int) -> int:
    """(column, triangle) tests the parity function needs on this mesh: the
    column centres inside each valid triangle's bounding box, clipped to the
    grid (the kernels test more: every column of a tile against its rows)."""
    from dxrvoxelizer_tpu_torch.ops.geom import parity_tri_setup

    pt = parity_tri_setup(verts, tris, n)

    def span(lo, hi):
        return torch.clamp(torch.clamp(torch.floor(hi), max=n - 1)
                           - torch.clamp(torch.ceil(lo), min=0) + 1, min=0)

    cols = span(pt.xmin, pt.xmax) * span(pt.ymin, pt.ymax) * (pt.valid > 0)
    return int(cols.double().sum())


def host_us(torch, fn, calls: int = 200) -> float:
    """Host time per call of ``fn`` (what the caller's thread spends to
    enqueue it), median of 5 runs of ``calls`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


def grid_sample_call(torch, res_args):
    """The resolve's gather as one PyTorch call (its yardstick): bilinear
    grid_sample of both intermediates, clamped to the edge, at the
    coordinates the resolve computes (``screen_coords``'s)."""
    import torch.nn.functional as F

    from dxrvoxelizer_tpu_torch.ops.screen_warp_cuda import resolve_screen_plain

    s_i, t_i = res_args[:2]
    _, gi_x, gi_y, _ = resolve_screen_plain(*res_args)
    if res_args[9]:  # swap
        s_i, t_i, gi_x, gi_y = s_i.t(), t_i.t(), gi_y, gi_x
    mm = s_i.shape[0]
    src = torch.stack([s_i, t_i])[None]  # [1, 2, M(x), M(y)]
    samp = torch.stack([gi_y, gi_x], -1).reshape(1, 1, -1, 2) / (mm - 1) * 2 - 1
    return lambda: F.grid_sample(
        src, samp, mode="bilinear", padding_mode="border", align_corners=True)


def march_live_steps(torch, args) -> int:
    """(pixel, sub-slab) steps csrc/march.cu must take on these inputs: the
    steps while a pixel's transmit is >= 0.01 (its loop bound), replayed
    with the plain version's warp and recurrence."""
    from dxrvoxelizer_tpu_torch.ops.march_cuda import zmix_slabs
    from dxrvoxelizer_tpu_torch.ops.raymarch_ref import ABSORPTION, ZERO_THRESHOLD
    from dxrvoxelizer_tpu_torch.ops.warp import (
        interp_matrix,
        scale_offset_coords,
        warp2d,
    )

    slabs, wts, front, sx, ox, sy, oy, delta, ss = args
    kn, n, m = slabs.shape[1], slabs.shape[2], delta.shape[0]
    dens = slabs[0]
    if ss > 1:
        i0, i1, _ = zmix_slabs(kn, ss, slabs.device)
        dens = dens[i0] * (1.0 - wts)[:, None, None] + dens[i1] * wts[:, None, None]
    dens_w = warp2d(dens, interp_matrix(scale_offset_coords(m, sx, ox), n),
                    interp_matrix(scale_offset_coords(m, sy, oy), n))
    transmit = torch.ones((m, m), device=slabs.device)
    live = torch.zeros((), dtype=torch.int64, device=slabs.device)
    for s in range(kn * ss):
        alive = transmit >= ZERO_THRESHOLD
        live += alive.sum()
        g = torch.clamp(dens_w[s] * 8.0, max=16.0)
        occ = (g > ZERO_THRESHOLD) & (front[s] > 0)
        att = torch.where(occ, torch.clamp(1.0 - g * delta * ABSORPTION, 0.0, 1.0),
                          torch.ones_like(g))
        transmit = torch.where(alive, transmit * att, transmit)
    return int(live)


def march_bound(torch, mi) -> tuple[float, str]:
    """Bound of the march on these inputs: the slabs, per-sub-slab tables
    and both [M, M] outputs once; the live steps' operations."""
    ks, mq = mi.slabs.shape[1] * mi.ss, mi.delta.shape[0]
    return bound(mi.slabs.numel() * 4 + 6 * ks * 4 + 3 * mq * mq * 4,
                 march_live_steps(torch, mi.args()) * MARCH_OPS_PER_STEP[mi.ss])


def resolve_hits(res_args) -> int:
    from dxrvoxelizer_tpu_torch.ops.screen_warp_cuda import resolve_screen_plain

    return int(resolve_screen_plain(*res_args)[3].sum())


def resolve_bound(res_args) -> tuple[float, str]:
    """Bound of the fused resolve: both intermediates read once and the
    image written once; the screen mapping's operations for every pixel and
    the taps', samples' and composite's for the hit pixels."""
    s_i, w, h = res_args[0], res_args[5], res_args[6]
    p_px = h * w
    return bound(2 * s_i.numel() * 4 + p_px * 3 * 4,
                 p_px * SCREEN_MAP_OPS_PER_PIXEL
                 + resolve_hits(res_args) * RESOLVE_OPS_PER_HIT)


def raystab_work(torch, rsc, tb) -> tuple[int, int, int]:
    """What a ray-stab kernel must do on the main strip stream (each strip
    has its own candidate rows): its real rays (not padding lanes) and the
    candidates of the chunks it tests. A chunk is skipped when every lane's
    best t over the chunks before it is below the chunk's bound; the best t
    is replayed with the plain fold. -> (real rays, candidate rows tested,
    real (ray, candidate) pairs tested)."""
    r, kb = tb.rays, rsc.K_BLOCK
    real = (~((r[:, 0] == 0) & (r[:, 1] == 0) & (r[:, 2] == 0))).sum(1)
    cnt = tb.cand_cnt.long()
    tested = torch.clamp(cnt, max=kb)
    for j in range(1, 0 if tb.bounds is None else tb.bounds.shape[1]):
        sel = torch.nonzero(cnt > j * kb).reshape(-1)  # strips with chunk j
        if not sel.numel():
            break
        head = dataclasses.replace(
            tb, rays=tb.rays[sel], cand_off=tb.cand_off[sel],
            cand_cnt=torch.clamp(tb.cand_cnt[sel], max=j * kb),
            bounds=tb.bounds[sel])
        best_t, _ = rsc.fold_plain(head)
        runs = (best_t >= tb.bounds[sel, j, None]).any(1)
        tested[sel] += torch.where(runs, torch.clamp(cnt[sel] - j * kb, 0, kb), 0)
    tested = tested * (real > 0)
    return (int(real.sum()), int(tested.sum()),
            int((real.long() * tested).sum()))


def raystab_bound(tb, work, extract: bool) -> tuple[float, str]:
    """Bound of a ray-stab kernel: the tested candidates' rows (20 floats
    with extraction: g0 g1 g2 c id n0 n1 n2; 11 for the fold alone; through
    row ids, each tested candidate's id and the table's rows instead), each
    real ray's 4 floats and its outputs (t, id, and the 4 channels with
    extraction), the offsets, counts and bounds, each once; the tested real
    pairs' operations."""
    real, tested, pairs = work
    row_f = 20 if extract else 11
    rows = (tested * row_f if tb.row_ids is None
            else tested + tb.rows.shape[0] * row_f)
    n_in = (rows + real * 4 + 2 * tb.strips
            + (0 if tb.bounds is None else tb.bounds.numel())) * 4
    n_out = real * (4 + 4 + (16 if extract else 0))
    return bound(n_in + n_out, pairs * RAYSTAB_OPS_PER_PAIR)


def queue_tested_pairs(torch, vqc, coefs, spans, chunk_tile, chunk_nsub,
                       n) -> tuple[int, int]:
    """(column, row) pairs the work-queue kernel tests on a queue: each live
    row of a valid triangle against the columns it picks in its tile (its
    span widened by one column, or the whole tile for a sliver); and what
    the parent kernel tested, all 128 columns of each such row."""
    k = coefs.shape[0] // chunk_tile.shape[0]
    slot = torch.arange(coefs.shape[0], device=coefs.device) % k
    live = slot < (chunk_nsub.long() * 8).repeat_interleave(k)
    valid = live & (coefs[:, 15] > 0)
    ts = vqc.row_columns(coefs, spans, chunk_tile, n)
    cols = ((ts[:, 1] - ts[:, 0] + 1).clamp(min=0)
            * (ts[:, 3] - ts[:, 2] + 1).clamp(min=0))
    return int((cols * valid).sum()), int(valid.sum()) * 128


def binned_tested_pairs(torch, vc, coef, spans, counts, n) -> tuple[int, int]:
    """(column, row) pairs kernel 2.1 tests on binned tiles: each real row of
    a valid triangle against the columns it picks in its tile (its span
    widened by one column, or the whole tile for a sliver) -> (rows walked,
    pairs tested)."""
    cols = vc.row_columns(coef, spans, n)  # [n_tiles, K, 4]
    real = torch.arange(coef.shape[1], device=coef.device)[None] < counts[:, None]
    valid = real & (coef[..., 15] > 0)
    tested = ((cols[..., 1] - cols[..., 0] + 1).clamp(min=0)
              * (cols[..., 3] - cols[..., 2] + 1).clamp(min=0))
    return int(counts.sum()), int((tested * valid).sum())


def raystab_pass_pairs(torch, rsc, tb) -> tuple[int, int, int, int]:
    """Over every real (ray, candidate) pair of a strip stream: the pairs,
    those past the sign test of the three dot products and |den| > eps
    (where csrc/raystab_fold.cu divides), the (warp, candidate) steps (32
    lanes against one candidate) with a real lane, and those holding at
    least one such pair. Replayed with the plain arithmetic a batch of
    strips at a time."""
    out = [0, 0, 0, 0]
    kmax = int(tb.cand_cnt.max()) if tb.strips else 0
    ks = torch.arange(kmax, device=tb.rays.device)
    for b0 in range(0, tb.strips, 256):
        r = tb.rays[b0:b0 + 256]
        off, cnt = (x[b0:b0 + 256].long() for x in (tb.cand_off, tb.cand_cnt))
        live = ks[None] < cnt[:, None]
        q = tb.rows[torch.where(live, off[:, None] + ks, 0)][:, None]  # [B,1,K,24]
        d = [r[:, i, :, None] for i in range(4)]  # [B,128,1]
        real = ~((d[0] == 0) & (d[1] == 0) & (d[2] == 0))
        w = [d[0] * q[..., 3 * i] + d[1] * q[..., 3 * i + 1]
             + d[2] * q[..., 3 * i + 2] for i in range(3)]
        den = w[0] + w[1] + w[2]
        wmin = torch.minimum(w[0], torch.minimum(w[1], w[2]))
        wmax = torch.maximum(w[0], torch.maximum(w[1], w[2]))
        pair = real & live[:, None, :]
        passed = pair & ((wmin >= 0) | (wmax <= 0)) & (den.abs() > 1e-10)
        out[0] += int(pair.sum())
        out[1] += int(passed.sum())
        nb = r.shape[0]
        out[2] += int(pair.reshape(nb, 4, 32, -1).any(2).sum())
        out[3] += int(passed.reshape(nb, 4, 32, -1).any(2).sum())
    return tuple(out)


def cold_event_us(torch, fn, flush, reps: int = 9) -> float:
    """Device time of one call of ``fn`` with the L2 cache flushed before it:
    CUDA events around the call, median of ``reps``."""
    times = []
    for _ in range(reps):
        flush.zero_()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) * 1e3)
    return statistics.median(times)


def by_id_case(torch, rsc, rf, verts, t_count: int, threshold: float,
               flush) -> tuple[int, dict]:
    """A refit of ``verts`` by refitter ``rf``: each stream, read through its
    row ids by the fold + extraction (the main path's and a setting of the
    sweep) and by the fold alone, against the plain versions on the
    rows it stands for, bit for bit, both rules; then the main stream's fold
    + extraction on the materialised rows and on the ids, timed by CUDA
    events in two passes (forward, then backward), warm and with the L2
    flushed. -> (candidate rows over the streams, {label: (warm us, L2-
    flushed us) of each pass})"""
    acc = rf.refit(verts)
    n_rows, times = 0, {}
    for f in rf._ids:
        tb = getattr(acc, f)
        check(tb.row_ids is not None and tb.rows.shape[0] == t_count + 1,
              f"a refitted {f} stream holds no row ids into the fused matrix")
        rows = dataclasses.replace(tb, rows=rsc.candidate_rows(tb), row_ids=None)
        n_rows += tb.row_ids.numel()
        for rule in ("backface", "hit"):
            want = rsc.fold_extract_plain(rows, t_count, threshold, rule)
            for variant in (None, (2, 2, False)):
                got = rsc.fold_extract(tb, t_count, threshold, rule,
                                       variant=variant)
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"fold_extract through the {f} stream's row ids "
                      f"({rule}, {variant}) differs from the plain version")
        check(all(torch.equal(a, b) for a, b in
                  zip(rsc.fold(tb), rsc.fold_plain(rows))),
              f"fold through the {f} stream's row ids differs from the plain fold")
        if f == "main":
            fns = {"materialised rows": lambda: rsc.fold_extract(
                       rows, t_count, threshold),
                   "row ids": lambda: rsc.fold_extract(tb, t_count, threshold)}
            order = [*fns, *reversed(fns)]
            for k in order:
                times.setdefault(k, []).append(
                    (cuda_ms(fns[k]) * 1e3, cold_event_us(torch, fns[k], flush)))
        del rows
    return n_rows, times


def cold_device_us(torch, fn, flush) -> float:
    """Device time per call of ``fn`` with the L2 cache flushed before each
    call: the profiler's time of flush + call, less the flush's alone."""
    return (device_us(lambda: (flush.zero_(), fn()))
            - device_us(flush.zero_))


def time_sweep(torch, fns: dict) -> dict:
    """CUDA-event ms and profiler device us per call of each function."""
    return {k: (cuda_ms(fn), device_us(fn)) for k, fn in fns.items()}


def mt_stage_pairs(torch, tb) -> list[int]:
    """Real (ray, candidate) pairs of a Moller-Trumbore slice stream that
    reach each stage of MT_OPS_BY_STAGE: all of them, then those past
    |det| > eps, u >= 0, v >= 0 and u + v <= 1, and the hits. Replayed with
    the plain ``mt_hit`` a batch of slices at a time."""
    from dxrvoxelizer_tpu_torch.ops.intersect import EPS_DET, mt_hit

    counts = [0] * len(MT_OPS_BY_STAGE)
    if tb.slices == 0 or tb.rows.shape[0] == 0:
        return counts
    dev = tb.pos.device
    kmax = int(tb.cand_cnt.max())
    step = max(1, (1 << 23) // (tb.lanes * max(1, kmax)))
    lanes = torch.arange(tb.lanes, device=dev)
    ks = torch.arange(kmax, device=dev)
    for b0 in range(0, tb.slices, step):
        roff, rcnt, coff, ccnt = (x[b0:b0 + step].long() for x in (
            tb.ray_off, tb.ray_cnt, tb.cand_off, tb.cand_cnt))
        rlive = lanes[None, :] < rcnt[:, None]  # [B, L]
        clive = ks[None, :] < ccnt[:, None]  # [B, K]
        rid = tb.ray_ids.long()[torch.where(rlive, roff[:, None] + lanes, 0)]
        o, d = tb.pos[rid][:, :, None, :], tb.dirs[rid][:, :, None, :]
        q = tb.rows[torch.where(clive, coff[:, None] + ks, 0)][:, None]
        e1, e2 = q[..., 3:6], q[..., 6:9]
        px = d[..., 1] * e2[..., 2] - d[..., 2] * e2[..., 1]
        py = d[..., 2] * e2[..., 0] - d[..., 0] * e2[..., 2]
        pz = d[..., 0] * e2[..., 1] - d[..., 1] * e2[..., 0]
        det = e1[..., 0] * px + e1[..., 1] * py + e1[..., 2] * pz
        _, u, v, hit = mt_hit(o, d, q[..., 0:3], e1, e2)
        m = rlive[:, :, None] & clive[:, None, :]
        stages = [m]
        for past in (det.abs() > EPS_DET, u >= 0.0, v >= 0.0, u + v <= 1.0, hit):
            m = m & past
            stages.append(m)
        for j, s in enumerate(stages):
            counts[j] += int(s.sum())
    return counts


def frames_in_turns(torch, fns) -> dict:
    """Time each frame function with cuda_ms in turns, in order and then
    back (a, b, c, c, b, a) -> {name: [ms, ms]}. Host time drifts within a
    run, so only frames timed in turns compare."""
    turns = {name: [] for name in fns}
    for name in [*fns, *reversed(fns)]:
        fn, p = fns[name]
        turns[name].append(cuda_ms(fn))
        p.sync()
    return turns


def app_run(torch, app_main, kernels, args, png: Path, name: str,
            shape=None):
    """Drive the app as a user does, with every launch count set to 0 just
    before and read just after; check the PNG (1280x720 unless ``shape``)
    -> (launches, covered)."""
    from dxrvoxelizer_tpu_torch.utils.image import read_png

    for k in kernels:
        k.launches = 0
    rc = app_main([*args, "-out", str(png)])
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    check(rc == 0, f"{name}: app exited {rc}")
    check(png.is_file(), f"{name}: the app wrote no PNG")
    img = read_png(png)
    shape = shape or (720, 1280, 3)
    check(img.shape == shape, f"{name}: PNG shape {img.shape}")
    clear_u8 = np.array([0, 51, 102])
    covered = float((np.abs(img.astype(int) - clear_u8).sum(-1) > 3).mean())
    check(0.05 < covered < 0.9, f"{name}: volume covers {covered:.3f} of the frame")
    return launches, covered


# FP32 operations of the render variants' kernels, counted from their
# sources (csrc/gather_march.cu, csrc/light_volume.cu, csrc/trilinear.cuh;
# additions, subtractions, multiplications, divisions, floors and square
# roots; compares, min/max and selects not counted): per density sample
# the position 6, the texture coordinate 6, the taps 12 (c = tex * n - 0.5,
# its floor and fraction per axis), the seven lerps 21 and GetSample's
# scaling 1 = 46; per contributing step of the march sigma, the
# attenuation and the product 3, the light volume's seven lerps 21 and the
# scatter's three operations = 27; per hit pixel the composite 17; per
# pixel the fused ray set-up 70 (the screen point 3, the row-order
# transform's 16 products and 12 sums, the division by h.w 3, the
# difference to the eye 3, the norm 6, the direction 3, three slab tests of
# 6 and the entry point 6); per light step the sample's 46 and the
# attenuation's three = 49; per voxel of the point light its normalised
# step 15
GATHER_OPS_PER_SAMPLE = 46
GATHER_OPS_PER_LIGHT = 27
GATHER_OPS_PER_HIT = 17
GATHER_OPS_PER_PIXEL = 70
LIGHT_OPS_PER_STEP = 49
LIGHT_OPS_PER_POINT_VOXEL = 15
# a point light inside the volume, in local space (the exact per-voxel field)
LIGHT_INSIDE = np.array([0.05, -0.1, 0.08], np.float32)


def gather_points(torch, rf, entry, ray_dir, p_idx, s_idx, n_samples):
    """The march's positions entry + dir * (s * step) of pixels ``p_idx``
    at steps ``s_idx`` -> [L, 3], rounded as the plain march rounds them."""
    soff = rf.sample_offsets(n_samples).to(entry.device)
    return entry[p_idx] + ray_dir[p_idx] * soff[s_idx][:, None]


def light_points(torch, t, vec, v_idx, j_idx, n, point: bool, n_light=32):
    """The light march's positions pos0 + step * (j + 1) of voxels ``v_idx``
    at steps ``j_idx`` -> [L, 3], rounded as the plain version rounds them."""
    from dxrvoxelizer_tpu_torch.ops.raymarch_ref import MAX_DIST, norm3

    dev = v_idx.device
    t, vec = t.to(dev), vec.to(dev)
    pos0 = torch.stack([t[v_idx // (n * n)], -t[(v_idx // n) % n],
                        t[v_idx % n]], dim=-1)
    if point:
        ld = vec - pos0
        step = ld / norm3(ld)[:, None] * (MAX_DIST / n_light)
    else:
        step = vec
    return pos0 + step * (j_idx + 1).to(torch.float32)[:, None]


def live_steps(torch, steps, n_steps):
    """(ray, step) of every live step: ray r's first steps[r] steps."""
    s_idx, r_idx = (torch.arange(n_steps, device=steps.device)[:, None]
                    < steps[None, :]).nonzero(as_tuple=True)
    return r_idx, s_idx


def gather_registers(log: str) -> str:
    """ptxas's registers and spill stores for the gather renderer's kernels,
    from the build log."""
    out, name, spill = [], None, "?"
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name, spill = m.group(1), "?"
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            for sym in ("gather_march_kernel", "light_volume_kernel"):
                if sym in name:
                    out.append(f"{sym} {m.group(1)} registers, {spill} B "
                               "spilled")
                    break
            name = None
    return "; ".join(out)


def loads_past_break(torch, stop, k: int, n_steps: int, pos_at) -> int:
    """Steps whose taps a kernel that issues them K at a time loads and
    then discards: each loop's steps after its stop step, up to the end of
    that step's batch, that lie in the box (a step outside the box loads
    nothing). ``stop``: [R], the step that ended each loop (``n_steps`` if
    none); ``pos_at(r, s)``: the positions of loops ``r`` at steps ``s``."""
    stop = stop.long()
    end = torch.clamp((stop // k + 1) * k, max=n_steps)
    wasted = 0
    for o in range(1, k):
        r = (stop + o < end).nonzero(as_tuple=True)[0]
        if len(r):
            pos = pos_at(r, stop[r] + o)
            wasted += int((pos.abs() <= 1.0).all(dim=-1).sum())
    return wasted


def light_stops(torch, out, steps, n_light: int = 32):
    """The step at which each voxel's light march stopped: the one whose
    transmittance fell below 0.01, else the first outside the box, else
    ``n_light``."""
    from dxrvoxelizer_tpu_torch.ops.raymarch_ref import ZERO_THRESHOLD

    died = out.reshape(-1) < ZERO_THRESHOLD
    return torch.where(died, steps - 1, steps)


def grid_sample_at(torch, vols, pos):
    """One F.grid_sample call (the yardstick of the gathers alone):
    trilinear reads of the stacked [N,N,N] volumes at local-space points
    ``pos`` [L, 3], align_corners=False (texel centres at (i + 0.5) / N)
    and border padding (LINEAR_CLAMP) -> (call, [C, L] values)."""
    import torch.nn.functional as F

    src = torch.stack(vols)[None]  # [1, C, D=x, H=y, W=z]
    tex = pos * torch.tensor([0.5, -0.5, 0.5], device=pos.device) + 0.5
    grid = (tex * 2.0 - 1.0)[:, [2, 1, 0]].reshape(1, 1, 1, -1, 3)

    def call():
        return F.grid_sample(src, grid, mode="bilinear",
                             padding_mode="border", align_corners=False)

    return call, call().reshape(len(vols), -1)


def img_err(torch, a, b) -> tuple[float, float, float]:
    """(mean, p99, max) of |a - b| over every pixel and channel."""
    d = (a.double() - b.double()).abs().flatten()
    return float(d.mean()), float(torch.quantile(d, 0.99)), float(d.max())


def phase20(torch, app_main, kernels, card, dev, state) -> dict:
    """Phase 20: the render variants and the rest of the app shell.

    ``state``: the 64^3 and 256^3 frames' (cfg, mesh buffers, constants)
    and the meshes. Returns the two new kernels' launches, max errors,
    times, bounds and yardsticks for the result line."""
    from dxrvoxelizer_tpu_torch.core.pipeline import FramePipeline, render, voxelize
    from dxrvoxelizer_tpu_torch.ez import Engine
    from dxrvoxelizer_tpu_torch.models.camera import OrbitCamera
    from dxrvoxelizer_tpu_torch.ops import raymarch_fast as rf
    from dxrvoxelizer_tpu_torch.ops.raymarch_ref import MAX_DIST

    t_start = time.perf_counter()
    gm, lv_k = rf.GATHER_MARCH.name, rf.LIGHT_VOLUME.name
    launches = {gm: 0, lv_k: 0}
    lines = []
    cfg, mb, consts = state["64"]
    cfg_hi, mb7, consts7 = state["256"]
    clear = np.array(cfg.clear_color, np.float32)

    # ---- 20a. every new path through the app and the Engine -------------
    with tempfile.TemporaryDirectory() as td:
        obj = Path(td) / "icosphere6.obj"
        v6, t6 = state["mesh6"]
        write_obj(obj, v6 * WORLD_SCALE + WORLD_CENTER, t6)
        obj_arg = os.path.relpath(obj)
        grid_npy, prof_dir = Path(td) / "g.npy", Path(td) / "prof"
        base = ["-mesh", obj_arg, "-frames", str(FRAMES)]
        f = FRAMES
        # (name, extra flags, expected launches, image shape); None: any
        runs = [
            ("-renderimpl gather", ["-renderimpl", "gather"],
             {gm: f, lv_k: f, "march": 0, "resolve": 0}, None),
            ("-showmip 1", ["-showmip", "1"], {lv_k: 0, "march": f}, None),
            ("-showmip 1 -usemutex", ["-showmip", "1", "-usemutex"],
             {lv_k: 0, "march": f}, None),
            # the 16^3 mip level: the -hq light step spans < 1 slab (d0 = 0)
            ("-showmip 2 (16^3, d0 = 0)", ["-showmip", "2"],
             {lv_k: f, "march": f}, None),
            ("-showmip 2 -usemutex", ["-showmip", "2", "-usemutex"],
             {lv_k: f, "march": f}, None),
            ("-pointlight (light outside: the perspective sweep)",
             ["-pointlight"], {lv_k: 0, "march": f, "light_sweep_point": f},
             None),
            ("-pointlight -renderimpl gather",
             ["-pointlight", "-renderimpl", "gather"],
             {gm: f, lv_k: f, "light_sweep_point": 0}, None),
            ("-renderimpl ref 320x180", ["-renderimpl", "ref", "-width", "320",
                                         "-height", "180", "-frames", "1"],
             {gm: 0, lv_k: 0, "march": 0}, (180, 320, 3)),
            ("-ab", ["-ab"], {gm: 1, lv_k: 1, "march": f + 1}, None),
            ("-savegrid", ["-renderimpl", "gather", "-savegrid", str(grid_npy)],
             {gm: f}, None),
            ("-loadgrid", ["-renderimpl", "gather", "-loadgrid", str(grid_npy)],
             {gm: 1, lv_k: 1}, None),
            ("-timings", ["-timings"], {"march": f + 3}, None),
            ("-profile", ["-profile", str(prof_dir)], {"march": f}, None),
        ]
        app_lines = []
        for name, extra, want, shape in runs:
            t0 = time.perf_counter()
            got, covered = app_run(torch, app_main, kernels, [*base, *extra],
                                   Path(td) / "v.png", name, shape=shape)
            for k, c in want.items():
                check(got[k] == c, f"{name}: {k} launched {got[k]} times, "
                      f"expected {c}")
            launches[gm] += got[gm]
            launches[lv_k] += got[lv_k]
            app_lines.append(f"{name} {time.perf_counter() - t0:.2f} s covers "
                             f"{covered:.3f} ({got[gm]}, {got[lv_k]}, "
                             f"{got['march']})")
        check(grid_npy.is_file(), "-savegrid wrote no grid")
        traces = list(prof_dir.glob("trace_*.json"))
        check(len(traces) == 1 and traces[0].stat().st_size > 0,
              "-profile wrote no trace")
        for name, extra in (("-interactive", ["-interactive"]),
                            ("-preview", ["-preview", "-out",
                                          str(Path(td) / "p.png")])):
            for k in kernels:
                k.launches = 0
            rc = app_main([*base, *extra])
            torch.cuda.synchronize()
            check(rc == 0, f"{name}: the app exited {rc}")
            march_n = next(k.launches for k in kernels if k.name == "march")
            check(march_n == f, f"{name}: march launched {march_n} times")
            app_lines.append(f"{name} ran {f} frames")
        lines.append("phase 20 app runs (launches gather_march, light_volume, "
                     "march): " + "; ".join(app_lines))

        # the X-key alternate frame and the point light inside the volume,
        # through the Engine
        eng_lines = []
        for name, cfg_e, alt in (
                ("X-key alt frame", cfg.replace(mesh=str(obj)), True),
                ("-pointlight inside the volume",
                 cfg.replace(mesh=str(obj), point_light=True,
                             light_pt=tuple(float(x) for x in WORLD_CENTER)),
                 False)):
            for k in kernels:
                k.launches = 0
            # the JAX package's call: the device resolves to the card
            eng = Engine(cfg_e) if alt else Engine(cfg_e, dev)
            check(eng.device.type == "cuda", f"{name}: Engine on {eng.device}")
            cam = OrbitCamera(cfg.width, cfg.height)
            if alt:
                check(eng.toggle_path(), "toggle_path did not switch")
            for frame in range(f):
                if frame:
                    cam.orbit(12.0, 0.0)
                eng.update_frame(frame % 3, cam.eye, cam.view_proj)
                img = eng.render(frame % 3)
            eng.sync()
            got = {k.name: k.launches for k in kernels}
            check(bool(torch.isfinite(img).all()), f"{name}: not finite")
            want = ({gm: f, lv_k: f, "march": 0, "parity_voxelize": 0} if alt
                    else {lv_k: f, "march": f})
            for k, c in want.items():
                check(got[k] == c, f"{name}: {k} launched {got[k]} times, "
                      f"expected {c}")
            launches[gm] += got[gm]
            launches[lv_k] += got[lv_k]
            eng_lines.append(f"{name} launches {got}")
        lines.append("phase 20 Engine: " + "; ".join(eng_lines))

    # ---- 20b. the kernels against their plain versions ------------------
    # every case of the card tests: the frame's grid, a random grid with
    # fractional alphas and a ray-stab grid's 4-level alpha; the
    # directional light, a point light outside and inside; the frame's
    # camera, one inside the box and a view along an axis (1280x721: the
    # axis view's middle row is on the axis); a band
    cases_mod = state["cases"]
    errs = {gm: 0.0, lv_k: 0.0}
    cases = []
    grid64 = voxelize(mb, GRID)
    grid256 = voxelize(mb7, GRID_HI)
    cams = cases_mod.gather_cameras(cfg.width, cfg.height + 1)
    work = {}

    def hold(name, got, want, kernel):
        e = max_err(got, want)
        errs[kernel] = max(errs[kernel], e)
        check(e <= TOL_MARCH, f"{name} differs by {e:.3g}")
        return e

    for size, grid, c_ in ((GRID, grid64, consts), (GRID_HI, grid256, consts7)):
        g_ = torch.Generator().manual_seed(size)
        rnd = (torch.rand((size,) * 3, generator=g_) < 0.2).float()
        rnd[: size // 2] *= torch.rand((size // 2, size, size), generator=g_)
        grids = {"frame": grid.density().contiguous(), "random": rnd.to(dev),
                 "alpha": cases_mod.alpha_grid(size, 3, dev)}
        lvs = {}
        for gname, g in grids.items():
            for kind, pt, point in (("directional", c_.local_space_light_pt, False),
                                    ("point", c_.local_space_light_pt, True),
                                    ("inside", LIGHT_INSIDE, True)):
                t, vec = rf.light_setup(size, pt, point_light=point)
                want, steps = rf.light_volume_plain(g, t, vec, point_light=point,
                                                    return_steps=True)
                got = rf.light_volume(g, vec, point_light=point)
                e = hold(f"light_volume {size}^3 {gname} {kind}", got, want, lv_k)
                cases.append(f"light_volume {size}^3 {gname} {kind} {e:.3g}")
                lvs[(gname, kind)] = got
                if gname == "frame" and kind == "directional":
                    work[("light", size)] = (g, t, vec, steps, got)
        # the march: the frame's camera over each light volume, the other
        # cameras and grids over the directional one
        s2l, eye = c_.screen_to_local, c_.local_space_eye_pt
        dens = grids["frame"]
        march_cases = [(f"frame {k}", dens, lvs[("frame", k)], s2l, eye,
                        cfg.height) for k in ("directional", "point", "inside")]
        march_cases += [(f"camera {k}", dens, lvs[("frame", "directional")],
                         cams[k][0], cams[k][1], cfg.height + 1)
                        for k in ("inside", "axis")]
        march_cases += [(f"{k} grid", grids[k], lvs[(k, "directional")], s2l, eye,
                         cfg.height) for k in ("random", "alpha")]
        for name, g, lv, m_, eye_, h_ in march_cases:
            rays = rf.gather_rays(m_, eye_, cfg.width, h_, 0.0, dev)
            want, sd, sl, stop = rf.gather_march_plain(g, lv, *rays, clear,
                                                       return_steps=True)
            got = rf.gather_march(g, lv, m_, eye_, clear, cfg.width, h_)
            e = hold(f"gather_march {size}^3 {name}", got, want, gm)
            cases.append(f"gather_march {size}^3 {name} {e:.3g} "
                         f"({int(rays[2].sum())} hits)")
            if name == "frame directional":
                work[("gather", size)] = (g, lv, rays, sd, sl, stop)
                # a band of 64 rows from row 300: the frame's rows
                band = rf.gather_rays(m_, eye_, cfg.width, 64, 300.0, dev)
                got_b = rf.gather_march(g, lv, m_, eye_, clear, cfg.width, 64,
                                        y_offset=300.0)
                e_b = hold(f"gather_march {size}^3 band", got_b,
                           rf.gather_march_plain(g, lv, *band, clear,
                                                 px_chunk=20_000), gm)
                check(torch.equal(got_b, got.reshape(h_, cfg.width, 3)[300:364]
                                  .reshape(-1, 3)),
                      f"gather_march {size}^3 band differs from the frame's rows")
                cases.append(f"gather_march {size}^3 band of rows 300-363 "
                             f"{e_b:.3g}")
    lines.append("phase 20 kernels against their plain versions (max|err|): "
                 + "; ".join(cases))

    # ---- 20c. times, bounds and yardsticks at the main path's shapes -----
    times, dev_call, plain, bounds, library, work_lines = {}, {}, {}, {}, {}, []
    host, old_bounds = {}, {}
    for size, c_ in ((GRID, consts), (GRID_HI, consts7)):
        dens, t, vec, steps, lv = work[("light", size)]
        _, _, rays, sd, sl, stop = work[("gather", size)]
        m_, eye_ = c_.screen_to_local, c_.local_space_eye_pt
        n3 = size ** 3

        def lv_call(dens=dens, vec=vec):
            return rf.light_volume(dens, vec)

        def gm_call(dens=dens, lv=lv, m_=m_, eye_=eye_):
            return rf.gather_march(dens, lv, m_, eye_, clear, cfg.width,
                                   cfg.height)

        for k, fn in ((lv_k, lv_call), (gm, gm_call)):
            times[(k, size)] = cuda_ms(fn)
            dev_call[(k, size)] = device_us(fn)
            host[(k, size)] = host_us(torch, fn)
        plain[(lv_k, size)] = cuda_ms(
            lambda: rf.light_volume_plain(dens, t, vec), reps=3, inner=1)
        plain[(gm, size)] = cuda_ms(
            lambda: rf.raymarch_fast(dens, lv, m_, eye_, clear, cfg.width,
                                     cfg.height, use_kernel=False),
            reps=3, inner=1)
        live_l, live_d, live_c = int(steps.sum()), int(sd.sum()), int(sl.sum())
        hits = int(rays[2].sum())
        n_px = rays[2].numel()
        bounds[(lv_k, size)] = bound(n3 * 8, live_l * LIGHT_OPS_PER_STEP)
        march_ops = (live_d * GATHER_OPS_PER_SAMPLE + live_c * GATHER_OPS_PER_LIGHT
                     + hits * GATHER_OPS_PER_HIT)
        bounds[(gm, size)] = bound(2 * n3 * 4 + n_px * 12 + 24 * 4,
                                   march_ops + n_px * GATHER_OPS_PER_PIXEL)
        # the replaced kernel's formula: the rays read (37 bytes per pixel) and the step
        # offsets, no set-up operations
        old_bounds[(gm, size)] = bound(2 * n3 * 4 + n_px * (24 + 1 + 12)
                                       + 128 * 4, march_ops)
        # the loads a batch of K steps would issue past a break, for the
        # shipped K and the others: the light volume's (K = 1) and the
        # march's (K = 2) are the shipped kernels' own
        hit_px = rays[2].nonzero(as_tuple=True)[0]
        l_stop = light_stops(torch, lv, steps)
        g_stop = stop[hit_px]
        wasted = []
        for kk in (1, 2, 4, 8):
            w_l = loads_past_break(
                torch, l_stop, kk, 32, lambda r, s_: light_points(
                    torch, t, vec, r, s_, size, False))
            w_g = loads_past_break(
                torch, g_stop, kk, 128, lambda r, s_: gather_points(
                    torch, rf, rays[0], rays[1], hit_px[r], s_, 128))
            wasted.append(f"K={kk}: light {w_l} of {live_l + w_l} step loads "
                          f"({w_l / (live_l + w_l):.4f}), march {w_g} of "
                          f"{live_d + w_g} ({w_g / (live_d + w_g):.4f})")
        work_lines.append(
            f"{size}^3: light volume {live_l} live steps of {n3 * 32}; march "
            f"{live_d} density samples, {live_c} contributing, {hits} of "
            f"{n_px} pixels hit; step loads past a break (8 taps a step; "
            "in-box steps after the stop step, to the end of its batch): "
            + ", ".join(wasted))
        if size == GRID:
            # yardstick: one grid_sample over the same sample points
            pts_l = light_points(torch, t, vec, *live_steps(torch, steps, 32),
                                 size, False)
            r_idx, s_idx = live_steps(torch, sd, 128)
            pts = gather_points(torch, rf, rays[0], rays[1], r_idx, s_idx, 128)
            gs_l, vals_l = grid_sample_at(torch, [dens], pts_l)
            gs_g, vals_g = grid_sample_at(torch, [dens, lv], pts)
            library[lv_k] = cuda_ms(gs_l)
            library[gm] = cuda_ms(gs_g)
            dev_call[("grid_sample light", size)] = device_us(gs_l)
            dev_call[("grid_sample march", size)] = device_us(gs_g)
            # the yardstick reads what the kernels read (a sanity check)
            tex = pts * torch.tensor([0.5, -0.5, 0.5], device=dev) + 0.5
            e_ys = max_err(vals_g[0], rf._flat_trilinear(dens.reshape(-1),
                                                         size, tex))
            check(e_ys <= 1e-5, f"grid_sample reads differ by {e_ys:.3g}")
            work_lines.append(f"grid_sample yardstick: {vals_l.shape[1]} light "
                              f"and {vals_g.shape[1]} march points, reads within "
                              f"{e_ys:.3g} of the kernels' trilinear")
    lines.append(
        "phase 20 kernels (CUDA-event ms per call, 10 calls median of 5 / "
        "profiler device us per call / wrapper host us per call / plain ms, "
        "median of 3 / bound ms (by) / the march's bound under the formula of "
        "the kernel that read its rays): "
        + "; ".join(
            f"{k} {s}^3 {times[(k, s)]:.4f} / {dev_call[(k, s)]:.2f} / "
            f"{host[(k, s)]:.2f} / {plain[(k, s)]:.4f} / "
            f"{bounds[(k, s)][0]:.6f} ({bounds[(k, s)][1]})"
            + (f" / {old_bounds[(k, s)][0]:.6f} ({old_bounds[(k, s)][1]})"
               if k == gm else "")
            for k in (gm, lv_k) for s in (GRID, GRID_HI))
        + f"; grid_sample yardstick at {GRID}^3: march {library[gm]:.4f} ms "
        f"({dev_call[('grid_sample march', GRID)]:.2f} us), light volume "
        f"{library[lv_k]:.4f} ms ({dev_call[('grid_sample light', GRID)]:.2f} "
        f"us); " + "; ".join(work_lines) + f"; {card}")

    # ---- 20d. the product-path question: gather against warp -hq --------
    frames = {}
    for size, cfg_s, mb_s, c_ in ((GRID, cfg, mb, consts),
                                  (GRID_HI, cfg_hi, mb7, consts7)):
        for impl in ("warp", "gather"):
            p_ = FramePipeline(cfg_s, mb_s, render_impl=impl)
            frames[f"{impl} {size}"] = (lambda p_=p_, c_=c_: p_.frame(c_), p_)
    turns = frames_in_turns(torch, frames)
    prof = {name: profile_frames(fn, p.sync, kernels)
            for name, (fn, p) in frames.items()}
    frame_lines = []
    for name, (busy, per_frame, kus) in prof.items():
        ms_ = statistics.median(turns[name])
        frame_lines.append(
            f"{name} {turns[name][0]:.4f} / {turns[name][1]:.4f} ms, busy "
            f"{busy:.4f} ms (idle share {1 - busy / ms_:.3f}), {per_frame:.0f} "
            f"device ops per frame, kernel us per frame "
            f"{ {k: v for k, v in kus.items() if v} }")
    # render only, on a fixed grid: the gather renderer with its light
    # volume per frame and with one passed in, and shear-warp
    render_lines = []
    for size, cfg_s, grid, c_ in ((GRID, cfg, grid64, consts),
                                  (GRID_HI, cfg_hi, grid256, consts7)):
        lv = work[("light", size)][4]
        r = {"gather": cuda_ms(lambda: render(grid, c_, cfg_s, impl="gather")),
             "gather, light volume passed in": cuda_ms(
                 lambda: render(grid, c_, cfg_s, impl="gather",
                                light_volume=lv)),
             "warp -hq": cuda_ms(lambda: render(grid, c_, cfg_s))}
        render_lines.append(f"{size}^3 " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in r.items()))
    # both images against the shader-exact oracle at 64^3, 1280x720
    t0 = time.perf_counter()
    img_ref = render(grid64, consts, cfg, impl="ref")
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    check(bool(torch.isfinite(img_ref).all()), "raymarch_ref not finite")
    err_lines = []
    for impl in ("gather", "warp"):
        e = img_err(torch, render(grid64, consts, cfg, impl=impl), img_ref)
        err_lines.append(f"{impl} mean {e[0]:.6f} p99 {e[1]:.6f} max {e[2]:.6f}")
        check(e[0] < 0.03 and e[1] < 0.35, f"{impl} image far from the oracle")
    lines.append(
        "phase 20 product path, frames 1280x720 (CUDA events in turns: warp 64, "
        "gather 64, warp 256, gather 256 and back; profiler windows of "
        f"{PROFILE_FRAMES} frames): " + "; ".join(frame_lines)
        + "; render only (grid fixed): " + "; ".join(render_lines)
        + f"; images against raymarch_ref at {GRID}^3 1280x720 (ref "
        f"{ref_s:.2f} s on the card): " + "; ".join(err_lines) + f"; {card}")
    lines.append(f"phase 20 took {time.perf_counter() - t_start:.1f} s")
    for ln in lines:
        print(ln)
    return {"launches": launches, "errs": errs,
            "ms": {k: (times[(k, GRID)], plain[(k, GRID)]) for k in (gm, lv_k)},
            "bounds": {k: bounds[(k, GRID)] for k in (gm, lv_k)},
            "library": library}


# sharded frames (phase 21): the world sizes the in-process rank bodies run
SHARD_WORLDS = (2, 4)
DATAGEN_GRID = 128


def datagen_meshes(meshes) -> list:
    """At least 16 procedural meshes for the batch datagen (phase 21d):
    icospheres of subdivision 4-6 at several radii and centres, boxes, the
    tetrahedron -> [(name, verts, tris)]."""
    out = []
    for sub in (4, 5, 6):
        for radius, centre in ((0.72, (0.05, -0.03, 0.02)),
                               (0.55, (0.1, 0.05, -0.08)),
                               (0.35, (-0.2, 0.15, 0.1))):
            v, _, t = meshes.icosphere_mesh(sub, radius=radius, center=centre)
            out.append((f"ico{sub}_r{radius}", v, t))
    for lo, hi in (((-0.5, -0.25, -0.75), (0.5, 0.75, 0.25)),
                   ((-0.7, -0.6, -0.5), (0.6, 0.5, 0.7)),
                   ((-0.3, -0.3, -0.3), (0.3, 0.3, 0.3)),
                   ((-0.8, -0.1, -0.4), (0.2, 0.4, 0.8))):
        v, _, t = meshes.box_mesh(lo, hi)
        out.append((f"box{len(out)}", v, t))
    for scale in (0.8, 0.5, 0.95):
        v, _, t = meshes.tetrahedron_mesh(scale=scale)
        out.append((f"tet{scale}", v, t))
    return out


def phase21(torch, app_main, kernels, card, dev, state) -> dict:
    """Phase 21: the multi-device frames (parallel/), batch datagen and the
    native C++ tier.

    a. A NCCL group of world size 1 runs ShardedFramePipeline at full
       width: 64^3 -hq on the 81,920-triangle icosphere, 256^3 parity and
       gen-7 ray-stab on the 327,680-triangle one, the 64^3 gen-6 ray-stab
       frame, the 64^3 gather frame and the 64^3 -pointlight frame (X.5);
       the merges and densities on their kernels (gen-7 X.6, gen-6 X.10,
       the parity frames' words X.7); each image against the
       single-device FramePipeline's, bit for bit; frame ms (CUDA events,
       median of 5 runs of 10 frames), device ops per frame (profiler),
       the all_gather's bytes and ms. The counts
       are set to 0 just before these frames and read just after.
    b. The same frames' rank bodies at world 2 and 4 in this process (a
       local group): every tile group of kernel 2.2, band of kernel 2.4 and
       strip slice of kernel 2.5/2.6 against its plain version and against
       the whole call, bit for bit; the frames against world 1's.
    c. -chips 2 on this one-card machine raises, and runs nothing.
    d. Batch datagen at 128^3 on 16+ procedural meshes, -impl queue and
       pallas (kernels 2.2 and 2.1; their words equal): meshes per second.
    e. The native tier: each library's build seconds (phase 1); the OBJ
       parse, the
       ray table and the gen-6 256^3 accel build's pack walk native against
       Python (DXRV_RAYSTAB_GEN=6 builds), equal bit for bit.
    Returns the launches of the paths a and d."""
    from dxrvoxelizer_tpu_torch.core.pipeline import FramePipeline
    from dxrvoxelizer_tpu_torch.ops import raystab_cuda as rsc
    from dxrvoxelizer_tpu_torch.ops import raystab_fast as rsf
    from dxrvoxelizer_tpu_torch.ops import screen_warp_cuda as swc
    from dxrvoxelizer_tpu_torch.ops import voxelize_queue as vq
    from dxrvoxelizer_tpu_torch.ops import voxelize_queue_cuda as vqc
    from dxrvoxelizer_tpu_torch.ops.march_cuda import march
    from dxrvoxelizer_tpu_torch.ops.packing import unpack_bits_z
    from dxrvoxelizer_tpu_torch.ops.raymarch_warp import march_inputs
    from dxrvoxelizer_tpu_torch.parallel import (
        ShardedFramePipeline,
        make_device_mesh,
        make_local_group,
    )
    from dxrvoxelizer_tpu_torch.parallel import datagen
    from dxrvoxelizer_tpu_torch.parallel.raystab_shard import (
        stream_piece,
        stream_sizes,
    )
    from dxrvoxelizer_tpu_torch.parallel.shard import (
        light_volume_from_statics,
        queue_group_piece,
        split,
    )
    from dxrvoxelizer_tpu_torch.utils import native
    from dxrvoxelizer_tpu_torch.utils.objloader import load_obj

    t_start = time.perf_counter()
    cfg, mb, consts = state["64"]
    cfg_hi, mb7, consts7 = state["256"]
    meshes = state["meshes"]
    frames = {  # name -> (cfg, mesh buffers, constants)
        "64 -hq": (cfg, mb, consts),
        "256 parity": (cfg_hi, mb7, consts7),
        "256 raystab gen-7": (cfg_hi.replace(inside_mode="raystab"), mb7,
                              consts7),
        "64 raystab gen-6": (cfg.replace(inside_mode="raystab"), mb, consts),
        "64 gather": (cfg, mb, consts),
        "64 -pointlight": (cfg.replace(point_light=True), mb, consts),
    }
    impl = {"64 gather": "gather"}

    # ---- 21a. world size 1 on a NCCL group: the main path ----------------
    group = make_device_mesh(1)
    check(group.backend == "nccl" and group.world == 1
          and group.device == dev, f"phase 21a group {group}")
    pipes = {name: ShardedFramePipeline(c_, m_, 1, group=group,
                                        render_impl=impl.get(name, "warp"))
             for name, (c_, m_, _) in frames.items()}
    singles = {name: FramePipeline(c_, m_, render_impl=impl.get(name, "warp"))
               for name, (c_, m_, _) in frames.items()}
    check(type(pipes["256 raystab gen-7"].accel).__name__ == "RaystabAccel7"
          and type(pipes["64 raystab gen-6"].accel).__name__ == "RaystabAccel2",
          "phase 21a: the sharded ray-stab frames are not gen-7 and gen-6")
    for name in frames:  # first frames (statics, accels from the cache)
        pipes[name].frame(frames[name][2])
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    imgs = {name: pipes[name].frame(frames[name][2]) for name in frames}
    for p in pipes.values():
        p.sync()
    launches = {k.name: k.launches for k in kernels}
    for k in ("parity_queue", "march", "resolve", "raystab_fold_extract",
              "gather_march", "light_volume", "light_sweep_point",
              "grid_untile", "grid_merge", "grid_unpack"):
        check(launches[k] > 0, f"phase 21a: kernel {k} never launched on the "
              "sharded frames")
    # the merges and the parity frames' densities on their kernels: gen-7
    # through X.6, gen-6 through X.10, the words through X.7 (its frames)
    check(launches["grid_untile"] == 1 and launches["grid_merge"] == 1
          and launches["grid_unpack"] == 4,
          f"phase 21a: glue launches {launches}")
    check(launches["parity_voxelize"] == 0 and launches["raystab_mt"] == 0,
          f"phase 21a: the sharded frames took another route: {launches}")
    for name, (c_, m_, k_) in frames.items():
        want = singles[name].frame(k_)
        check(imgs[name].shape == (720, 1280, 3) and torch.equal(imgs[name], want),
              f"phase 21a {name}: sharded image differs from FramePipeline's "
              f"by {max_err(imgs[name], want):.3g}")
    timing = {}
    for name, (c_, m_, k_) in frames.items():
        p = pipes[name]
        fn = lambda p=p, k_=k_: p.frame(k_)  # noqa: E731
        ms_ = cuda_ms(fn)
        p.sync()
        busy, per_frame, _ = profile_frames(fn, p.sync, kernels)
        fr = p._frames[next(iter(p._frames))]
        ctx = (m_.positions_norm, p.mesh.tris, None, None, None, None)
        piece = fr.piece(0, ctx)
        gather_ms = cuda_ms(lambda piece=piece: group.all_gather(piece))
        timing[name] = (ms_, busy, per_frame, piece.numel() * piece.element_size(),
                        gather_ms)
    print("phase 21a ShardedFramePipeline on a NCCL group of 1 rank, "
                 "1280x720, each image bit-identical to FramePipeline's "
                 f"(launches {launches}): " + "; ".join(
                     f"{k}: {v[0]:.4f} ms per frame (CUDA events, {INNER} "
                     f"frames, median of {REPS}), device busy {v[1]:.4f} ms, "
                     f"{v[2]:.0f} device ops per frame, all_gather "
                     f"{v[3]} bytes in {v[4]:.4f} ms"
                     for k, v in timing.items()) + f"; {card}")

    # ---- 21b. rank bodies at world 2 and 4 in this process ---------------
    checked = {"2.2 tile groups": 0, "2.4 bands": 0, "2.5/2.6 slices": 0,
               "frames": 0}
    n_hi = cfg_hi.grid_size
    n_tiles = (n_hi // vqc.TILE_X) * (n_hi // vqc.TILE_Y)
    cap = pipes["256 parity"].num_chunks_cap
    whole_q = vq.StaticVoxelizer(mb7.positions_norm, mb7.tris, n_hi)()
    accel7 = pipes["256 raystab gen-7"].accel
    accel6 = rsf.build_raystab_accel2(mb.positions_norm, mb.tris, mb.normals,
                                      n=cfg.grid_size)
    stab = [(a, rsc.fold_extract(a.main, a.t_count, cfg.inside_threshold))
            for a in (accel6, accel7)]
    cfg_b, _, k_b = frames["64 -hq"]
    p1 = pipes["64 -hq"]
    statics = next(iter(p1._frames))
    (waxis, wflip, wswap, m, l_axis, l_flip, l_mode, ss, l_d0) = statics
    words64 = vq.voxelize_parity_queue(mb.positions_norm, mb.tris,
                                       cfg.grid_size)
    density = unpack_bits_z(words64, cfg.grid_size).to(torch.float32)
    lv = light_volume_from_statics(density, k_b.local_space_light_pt,
                                   cfg.grid_size, l_axis, l_flip, l_mode,
                                   l_d0=l_d0)
    mi = march_inputs(density, lv, k_b.local_space_eye_pt, cfg.grid_size, m,
                      waxis, wflip, ss)
    tr, sc = march(*mi.args(), ring=mi.ring)
    res_args = (sc, tr, k_b.screen_to_local, k_b.local_space_eye_pt,
                np.array(cfg.clear_color, np.float32), cfg.width)
    whole_r = swc.resolve_screen(*res_args, cfg.height, waxis, wflip, wswap, mi)
    resolve_err = 0.0
    for w in SHARD_WORLDS:
        # 2.2: each rank's tile group of the 256^3 parity frame
        pieces = []
        for r in range(w):
            lo, hi = split(n_tiles, w, r)
            piece = queue_group_piece(mb7.positions_norm, mb7.tris, n_hi, cap,
                                      w, r)
            q = vq._build_queue_device(mb7.positions_norm, mb7.tris, n_hi, cap,
                                       *vq.SPAN_CAP, tile_lo=lo, tile_hi=hi)
            check(bool(q[5]), f"phase 21b: group {r}/{w} overflowed {cap}")
            plain = vqc.voxelize_parity_queue_chunks_plain(
                q[0], q[2], q[3], n_hi, tile_lo=lo, tiles=hi - lo)
            check(torch.equal(piece, plain),
                  f"phase 21b: 2.2 tile group {r}/{w} differs from its plain "
                  "version")
            pieces.append(piece)
            checked["2.2 tile groups"] += 1
        check(torch.equal(vqc._tiles_to_grid(torch.cat(pieces), n_hi), whole_q),
              f"phase 21b: 2.2 tile groups of world {w} differ from the whole "
              "grid")
        # 2.4: each rank's band of the 64^3 -hq frame
        band = cfg.height // w
        for r in range(w):
            got = swc.resolve_screen(*res_args, band, waxis, wflip, wswap, mi,
                                     coords=True, y_off=r * band)
            want = swc.resolve_screen_plain(*res_args, band, waxis, wflip,
                                            wswap, mi, y_off=r * band)
            check(all(torch.equal(a, b) for a, b in zip(got[1:], want[1:])),
                  f"phase 21b: 2.4 band {r}/{w} coordinates differ from "
                  "screen_coords")
            resolve_err = max(resolve_err, max_err(got[0], want[0]))
            check(resolve_err <= TOL_RESOLVE, f"phase 21b: 2.4 band {r}/{w} "
                  f"differs from its plain version by {resolve_err:.3g}")
            check(torch.equal(got[0], whole_r[r * band:(r + 1) * band]),
                  f"phase 21b: 2.4 band {r}/{w} differs from the whole image's "
                  "rows")
            checked["2.4 bands"] += 1
        # 2.5/2.6: each rank's strip slices, gen-6 64^3 and gen-7 256^3
        for a, whole_f in stab:
            tb = a.main
            for r in range(w):
                lo, hi = split(tb.strips, w, r)
                sl = rsc.strip_slice(tb, lo, hi)
                got = rsc.fold_extract(sl, a.t_count, cfg.inside_threshold)
                for g_, w_ in zip(got, whole_f):
                    check(torch.equal(g_, w_[lo:hi]), f"phase 21b: 2.5/2.6 "
                          f"slice {r}/{w} differs from the whole stream's")
                # the plain version on the slice (gen-7 256^3: its first and
                # last 256 strips, the whole slice would take minutes)
                parts = ([(0, hi - lo)] if a is accel6 else
                         [(0, 256), (hi - lo - 256, hi - lo)])
                for s0, s1 in parts:
                    sub = rsc.strip_slice(sl, s0, s1)
                    want = rsc.fold_extract_plain(sub, a.t_count,
                                                  cfg.inside_threshold)
                    for g_, w_ in zip(got, want):
                        check(torch.equal(g_[s0:s1], w_), f"phase 21b: 2.5/2.6 "
                              f"slice {r}/{w} differs from its plain version")
                checked["2.5/2.6 slices"] += 1
            piece = stream_piece(a, w, 0, cfg.inside_threshold, "backface")
            check(piece.shape[0] == stream_sizes(a, w)[0],
                  "phase 21b: stream piece rows")
        # whole frames at world w against world 1's images
        for name, (c_, m_, k_) in frames.items():
            p = ShardedFramePipeline(c_, m_, w, group=make_local_group(w, dev),
                                     render_impl=impl.get(name, "warp"))
            check(torch.equal(p.frame(k_), imgs[name]),
                  f"phase 21b: {name} at world {w} differs from world 1")
            checked["frames"] += 1
    torch.cuda.synchronize()
    print(f"phase 21b rank bodies at world {SHARD_WORLDS} on the card: "
                 f"bit-identical to their plain versions and to the whole calls "
                 f"({checked}; the resolve's image within {resolve_err:.3g} of "
                 "resolve_screen_plain, its coordinates and mask bit for bit); "
                 "each frame equal to world 1's")
    group.close()

    # ---- 21c. -chips 2 on a one-card machine raises -------------------------
    with tempfile.TemporaryDirectory() as td:
        obj = Path(td) / "tet.obj"
        write_obj(obj, *meshes.tetrahedron_mesh()[::2])
        try:
            app_main(["-mesh", os.path.relpath(obj), "-chips", "2",
                      "-frames", "1"])
        except ValueError as e:
            check("requested 2 devices, found 1" in str(e),
                  f"phase 21c: -chips 2 raised {e!r}")
            print(f"phase 21c -chips 2 on {torch.cuda.device_count()} "
                         f"card raised: {e}")
        else:
            raise RuntimeError("phase 21c: -chips 2 ran on one card")

    # ---- 21d. batch datagen at 128^3 ------------------------------------------
    dg_launch = {"parity_queue": 0, "parity_voxelize": 0}
    with tempfile.TemporaryDirectory() as td:
        paths = []
        for name, v, t in datagen_meshes(meshes):
            p = Path(td) / f"{name}.obj"
            write_obj(p, v, t)
            paths.append(str(p))
        check(len(paths) >= 16, "phase 21d: fewer than 16 meshes")
        rates, words = {}, {}
        for dg_impl in ("queue", "pallas"):
            datagen.voxelize_batch(paths[:1], n=DATAGEN_GRID, impl=dg_impl,
                                   devices=[dev])  # warm-up
            torch.cuda.synchronize()
            for k in kernels:
                k.launches = 0
            t0 = time.perf_counter()
            res = datagen.voxelize_batch(paths, n=DATAGEN_GRID, impl=dg_impl,
                                         out_dir=Path(td) / dg_impl,
                                         devices=[dev])
            secs = time.perf_counter() - t0
            for k in kernels:
                if k.name in dg_launch:
                    dg_launch[k.name] += k.launches
            rates[dg_impl] = (len(res) / secs, secs)
            words[dg_impl] = [np.load(r.out_file) for r in res]
            check(all(r.occupied > 0 for r in res),
                  f"phase 21d: {dg_impl} voxelized an empty mesh")
        check(dg_launch["parity_queue"] >= len(paths)
              and dg_launch["parity_voxelize"] >= len(paths),
              f"phase 21d: datagen launches {dg_launch}")
        for a_, b_ in zip(words["queue"], words["pallas"]):
            check(np.array_equal(a_, b_), "phase 21d: queue and pallas words "
                  "differ")
        # the oracle on the small meshes (boxes and tetrahedra)
        small = [i for i, p in enumerate(paths)
                 if Path(p).stem.startswith(("box", "tet"))]
        for i in small:
            r = datagen.voxelize_mesh_file(paths[i], n=DATAGEN_GRID, impl="xla",
                                           device=dev)
            check(r.occupied == int(np.unpackbits(
                words["queue"][i].view(np.uint8)).sum()),
                  f"phase 21d: {paths[i]} oracle count differs")
    print(f"phase 21d datagen at {DATAGEN_GRID}^3 on {len(paths)} meshes "
                 "(icospheres of subdivision 4-6, boxes, tetrahedra; OBJ parse "
                 "included; words of both impls equal, and the oracle's counts "
                 f"on the {len(small)} small meshes): " + "; ".join(
                     f"-impl {k} {v[0]:.2f} meshes/s ({v[1]:.3f} s)"
                     for k, v in rates.items())
                 + f"; launches {dg_launch}; {card}")

    # ---- 21e. the native tier -------------------------------------------------
    builds = state["native_builds"]
    with tempfile.TemporaryDirectory() as td:
        obj7 = Path(td) / "ico7.obj"
        write_obj(obj7, *state["mesh7"])
        parse = {}
        for pi in ("native", "python"):
            t0 = time.perf_counter()
            parsed = load_obj(obj7, impl=pi)
            parse[pi] = (time.perf_counter() - t0, parsed)
        check(np.array_equal(parse["native"][1].indices,
                             parse["python"][1].indices)
              and np.array_equal(parse["native"][1].positions,
                                 parse["python"][1].positions),
              "phase 21e: native and Python OBJ parses differ")
    raytab = {}
    for n_, g_ in ((128, 64), (GRID_HI, 128)):
        t0 = time.perf_counter()
        rt_n = native.raytab_native(n_, g_)
        raytab[(n_, "native")] = time.perf_counter() - t0
        if n_ == 128:  # the numpy argsorts take seconds at 256^3
            t0 = time.perf_counter()
            rt_p = rsf._ray_table_filled_py(n_, g_)
            raytab[(n_, "python")] = time.perf_counter() - t0
            check(all(np.array_equal(a_, b_) for a_, b_ in zip(rt_n, rt_p)),
                  "phase 21e: native and Python ray tables differ")
    seen = []
    real = rsf._make_packs
    os.environ["DXRV_RAYSTAB_GEN"] = "6"
    rsf._make_packs = lambda *a: seen.append(a) or real(*a)
    try:
        rsf._ray_table_filled.cache_clear()
        t0 = time.perf_counter()
        compact6 = rsf.build_raystab_compact2(mb7.positions_norm, mb7.tris,
                                              n=GRID_HI)
        build_native_s = time.perf_counter() - t0
    finally:
        rsf._make_packs = real
        del os.environ["DXRV_RAYSTAB_GEN"]
    (cell_csr, ray_table, rc, tri_bounds), = seen
    walk = {}
    for wi, fn in (("native", lambda: native.accel_pack_native(
            *cell_csr, ray_table, rc, tri_bounds)),
                   ("python", lambda: rsf._make_packs_py(
            cell_csr, ray_table, rc, tri_bounds))):
        t0 = time.perf_counter()
        out = fn()
        walk[wi] = (time.perf_counter() - t0, out)
    check(all(np.array_equal(a_, b_) for a_, b_ in zip(walk["native"][1],
                                                      walk["python"][1])),
          "phase 21e: native and Python pack walks differ")
    print(
        "phase 21e native tier: g++ builds (s) "
        + ", ".join(f"{k} {v:.3f}" for k, v in builds.items())
        + f"; OBJ parse of the {len(state['mesh7'][1])}-triangle icosphere: "
        f"native {parse['native'][0]:.4f} s, Python {parse['python'][0]:.4f} s "
        "(equal); ray table (s): " + ", ".join(
            f"{n_}^3 {k} {v:.4f}" for (n_, k), v in raytab.items())
        + f" (128^3 equal); gen-6 {GRID_HI}^3 compact with the native pack "
        f"walk and ray table {build_native_s:.4f} s "
        f"({compact6.stats.levels[0][4]} strips); the walk alone on its inputs: "
        f"native {walk['native'][0]:.4f} s, Python {walk['python'][0]:.4f} s "
        f"(equal CSR quadruples, {len(walk['native'][1][1]) - 1} packs); "
        "host times, the card's host CPU")
    print(f"phase 21 took {time.perf_counter() - t_start:.1f} s")
    return {"launches": {k: launches[k] + dg_launch.get(k, 0) for k in launches}}


# the kernels the benchmark's timed calls must launch (2.1 for the 64^3
# render density, 2.2, the march and the resolve, the gen-6/7 fold)
BENCH_KERNELS = ("parity_voxelize", "parity_queue", "march", "resolve",
                 "raystab_fold_extract")
# the kernels whose outputs the benchmark holds against their plain versions
# (the queue's words; the march and the image at 1920x1080)
BENCH_HELD = ("parity_queue", "march", "resolve")
BENCH_TIMEOUT_S = 600


def phase22(torch, root: Path) -> tuple[dict, dict]:
    """Run ``python -m dxrvoxelizer_tpu_torch.bench`` on the card as a
    subprocess; print its JSON line and wall time; fail unless it exits 0
    with every key of ``bench.expected_keys()``, no ``failed_`` key, a
    launch of each of BENCH_KERNELS and an error from each of BENCH_HELD ->
    (its launches, its largest error per kernel held against its plain
    version)."""
    from dxrvoxelizer_tpu_torch import bench

    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the bench's 512^3 and 1024^3 entries
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "dxrvoxelizer_tpu_torch.bench"], cwd=root,
        capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    print(f"phase 22 bench: exit {res.returncode} in {wall:.1f} s")
    lines = res.stdout.strip().splitlines()
    if res.returncode != 0 or not lines:
        print(res.stderr[-6000:], file=sys.stderr)
        raise RuntimeError(f"phase 22: the bench exited {res.returncode}")
    print(lines[-1])
    line = json.loads(lines[-1])
    sec = line["secondaries"]
    missing = [k for k in bench.expected_keys() if k not in sec]
    failed = [k for k in sec if k.startswith("failed_")]
    check(not missing and not failed,
          f"phase 22: the bench lacks {missing}, failed {failed}")
    check(line["value"] == sec["voxelize_256_ms"]
          and line["metric"].endswith("_voxelize_256cubed_ms"),
          "phase 22: the headline is not the 256^3 voxelize")
    launches, errs = line["launches"], line["max_abs_err"]
    for k in BENCH_KERNELS:
        check(launches[k] > 0, f"phase 22: the bench never launched {k}")
    check(set(errs) == set(BENCH_HELD),
          f"phase 22: the bench held {sorted(errs)}, not {BENCH_HELD}")
    print(f"phase 22 bench launches {launches}; max|err| against the plain "
          f"versions {errs}; stderr tail: "
          + " | ".join(res.stderr.strip().splitlines()[-4:]))
    return launches, errs


# the light recurrences' kernel (phase 22b): its bound against the plain
# versions (FP32 both; the plain versions' matmuls may sum a stencil's two
# terms in another order: 1e-5, the port's bar against JAX,
# tests/test_torch_render.py), the grids its lights are held at (the
# reference step's window d0 = 1 at 32^3, 2-3 at 64^3, 4-6 at 128^3, 5-7 at
# 160^3, 8-13 at 256^3) and the 256^3 windows of the d0 lights
TOL_SWEEP = 1e-5
SWEEP_GRIDS = (32, 64, 128, 160, 256)
SWEEP_D0 = range(8, 14)
SWEEP_PAIRS = 10  # pairs of the --parent turns
# FP32 operations per voxel, counted from csrc/light_sweep.cu (additions,
# subtractions, multiplications, floors; compares, min/max and selects not
# counted). X.3, per voxel whose p+s lies in the box (the others only write
# 1): the weight's complement 1, the tap coordinates 2, the floor, fraction
# and complement of the clamped density taps 6, the density z-mixes 12 and
# their resample 9, the attenuation 3, the light taps 6, the light z-mixes
# 12 and their resample 9, the row sums and the complement 4, its addition
# and the product 2 = 66. X.4, per voxel: the tap coordinates 2 and taps 6,
# each of the four carry taps' attenuation 3 and product 1 = 16, the
# resample 9, the row sums and the complement 4 and its addition 1 = 38.
# X.5, per voxel (square roots and divisions counted as one): the tap
# coordinates 4 and taps 6; the centres' offsets from the light and their
# squares at the two x and two y taps 4 x 4 = 16; per carry tap the
# crossing length 6 (two sums, the root, 2/n times it, the division by
# |dz|, ABSORPTION times it), the attenuation 3 and the product 1, 4 x 10
# = 40; the resample 9, the row sums, complement and addition 5 = 80
# (every voxel counted with four taps: the most it can need)
SWEEP_OPS = {"light_sweep_ref": 66, "light_sweep": 38,
             "light_sweep_point": 80}


def sweep_bound(rw, name: str, n: int, light) -> tuple[float, str]:
    """The density read and the field written once (8 bytes a voxel); the
    operations of the voxels this light's step needs computed."""
    lt = np.asarray(light, np.float32)
    live = n ** 3
    if name == "light_sweep_ref":
        axis, flip, d0 = rw.light_ref_statics(lt, n)
        xlo, xhi, ylo, yhi, kmax = rw.ref_statics(rw._light_key(lt), n, axis,
                                                  flip, d0).box
        live = (max(xhi - xlo + 1, 0) * max(yhi - ylo + 1, 0)
                * max(kmax + 1, 0))
    return bound(n ** 3 * 8, live * SWEEP_OPS[name])


def phase22b(torch, app_main, kernels, card, dev, state) -> dict:
    """Phase 22b: the light recurrences' kernel (csrc/light_sweep.cu: X.3,
    the -hq reference step, X.4, the -fast per-slab sweep, and X.5, the
    -pointlight perspective sweep).

    a. Each instance against its plain version on the card at 32, 64, 128,
       160 and 256^3, on a seeded random grid with fractional alphas: X.3
       and X.4 for lights of every major axis and sign with the windows
       d0 = 1..13, the CPU tests' lights and each cell's own light; X.5
       for point lights of every major axis and side, far, near the far
       face and off-axis (``tests/torch_cases.point_lights``); and all
       three on the 64^3 and 256^3 frames' own densities and lights. Over
       TOL_SWEEP fails; the largest error is printed per instance and grid.
    b. At the 64^3 and 256^3 frames' inputs: each instance's CUDA-event ms
       (INNER calls, median of REPS), device us per call (profiler), us per
       step and roofline share; its bound, the plain version's ms and
       device us; with ``state["parent"]`` (``--parent TREE``), TREE's
       kernel built alone (``scripts/light_sweep_turns.parent_sweep``) and
       this tree's in SWEEP_PAIRS pairs, the first side alternating, with
       the pairs this tree's won and each side's interquartile range
       (``pairs_in_turns``); X.5 "no parent kernel" where TREE has none.
    d. The app's ``-fast`` frames with every launch count set to 0 before
       and read after: X.4 once per frame, X.3 and X.5 never.
    e. The app's ``-pointlight`` frames at 64^3 and 256^3 the same way: X.5
       once per frame, X.3 and X.4 never; then those frames through
       ``FramePipeline`` with the kernel and with the point sweep's plain
       version (``use_kernel=False``): ms (CUDA events), device busy ms,
       device ops and X.5's device us per frame (profiler).

    ``state``: the 64^3 and 256^3 frames' (density, light), the meshes,
    the CPU tests' lights (``cases``) and ``--parent``. Returns the -fast and
    -pointlight runs' launches and, for the result line, each instance's
    largest error, its and its plain version's ms and its bound at the 64^3
    frame's inputs."""
    from benchmark.run import Runner, cell_from_spec, load_spec
    from dxrvoxelizer_tpu_torch.ops import raymarch_warp as rw

    t_start = time.perf_counter()
    cases = state["cases"]
    ref_k, dir_k = rw.LIGHT_SWEEP_REF, rw.LIGHT_SWEEP
    pt_k = rw.LIGHT_SWEEP_POINT
    names = (ref_k.name, dir_k.name, pt_k.name)

    def call(name, dens, light, n, **kw):
        """One field: X.3, X.4 or X.5 (``use_kernel`` passes through)."""
        lt = np.asarray(light, np.float32)
        if name == ref_k.name:
            return rw.light_sweep_ref(dens, lt, n, *rw.light_ref_statics(lt, n),
                                      **kw)
        if name == pt_k.name:
            axis, flip, sweep = rw.point_light_statics(lt, n)
            check(sweep, f"phase 22b: the point light {light} is not beyond "
                  f"the volume at {n}^3")
            return rw.light_sweep_point(dens, lt, n, axis, flip, **kw)
        return rw.light_sweep(dens, lt, n, *rw.light_statics(lt), **kw)

    def d0_of(name, light, n):
        return (rw.light_ref_statics(np.asarray(light, np.float32), n)[2]
                if name == ref_k.name else 1)

    # the cells: their runners (mesh, light, frames) and their lights
    spec = load_spec()
    tmp = Path(tempfile.mkdtemp(prefix="dxv_sweep_cells_"))
    atexit.register(shutil.rmtree, tmp, True)
    runners = {}
    for w in spec["workloads"]:
        (tmp / w["name"]).mkdir()
        runners[w["name"]] = Runner(cell_from_spec(w["name"], spec), 0, dev,
                                    tmp / w["name"])
    cell_lights = {c: tuple(float(x) for x in r.scene.update_frame(
        r.cam.eye, r.cam.view_proj, r.cfg.width,
        r.cfg.height).local_space_light_pt) for c, r in runners.items()}

    # ---- 22b-a. against the plain versions -------------------------------
    lights = [cases.d0_light(a, sg, d, GRID_HI) for a in range(3)
              for sg in (1.0, -1.0) for d in SWEEP_D0]
    lights += [*cases.SWEEP_LIGHTS, *cell_lights.values()]
    errs = {k: 0.0 for k in names}
    err_at = {}
    windows = set()
    gen = torch.Generator().manual_seed(15)
    for n in SWEEP_GRIDS:
        fill = torch.rand((n, n, n), generator=gen) < 0.2
        dens = (fill * torch.rand((n, n, n), generator=gen)).to(dev)
        runs = [(name, light) for light in lights
                for name in (ref_k.name, dir_k.name)]
        runs += [(pt_k.name, light) for light in cases.point_lights(n)]
        for name, light in runs:
            if name == ref_k.name:
                windows.add(rw.light_ref_statics(np.asarray(light, np.float32),
                                                 n))
            got = call(name, dens, light, n)
            want = call(name, dens, light, n, use_kernel=False)
            e = max_err(got, want)
            err_at[(name, n)] = max(err_at.get((name, n), 0.0), e)
            errs[name] = max(errs[name], e)
            check(e <= TOL_SWEEP, f"phase 22b: {name} {n}^3 light "
                  f"{light} differs from its plain version by {e:.3g}")
    check({d for _, _, d in windows} == set(range(1, 14))
          and {(a, f) for a, f, _ in windows}
          == {(a, f) for a in range(3) for f in (False, True)},
          f"phase 22b: the lights' windows {sorted(windows)}")
    frames = {GRID: state["64"], GRID_HI: state["256"]}
    for n, (dens, light) in frames.items():
        for name in names:
            e = max_err(call(name, dens, light, n),
                        call(name, dens, light, n, use_kernel=False))
            err_at[(name, f"frame {n}")] = e
            errs[name] = max(errs[name], e)
            check(e <= TOL_SWEEP, f"phase 22b: {name} on the {n}^3 frame "
                  f"differs from its plain version by {e:.3g}")
    print(f"phase 22b kernels against their plain versions (max|err|; "
          f"{len(lights)} lights at {SWEEP_GRIDS}^3, windows d0 "
          f"{sorted({d for _, _, d in windows})}, every axis and flip; the "
          f"cells' lights {cell_lights}; X.5: {len(cases.point_lights(GRID))} "
          f"point lights a grid, {cases.POINT_KINDS} on every axis and side, "
          f"and the frames' lights): " + ", ".join(
              f"{k[0]} {k[1]} {v:.3g}" for k, v in err_at.items()))

    # ---- 22b-b. times and bounds at the frames' inputs ---------------------
    def dev_us(fn):
        """device_us, once more where no window saw a device record (a long
        process's profiler drops some); 0.0: not measured."""
        return device_us(fn) or device_us(fn)

    def dev_text(us, bound_ms=None):
        if not us:
            return "device us not measured (no device record in the windows)"
        share = ("" if bound_ms is None else
                 f", share {bound_ms / (us / 1e3):.4f} of the device time")
        return f"{us:.2f} us device per call{share}"

    def step_text(us, n_steps):
        return f", {us / n_steps:.3f} us a step of {n_steps}" if us else ""

    timing = {}
    parent = None
    if state.get("parent"):
        turns = _load_script(Path(__file__).resolve().parent,
                             "light_sweep_turns")
        parent = turns.parent_sweep(
            Path(state["parent"]).resolve(),
            Path(tempfile.mkdtemp(prefix="dxv_parent_")))
    for n, (dens, light) in frames.items():
        for name in names:
            n_steps = -(-n // d0_of(name, light, n))
            bnd = sweep_bound(rw, name, n, light)
            fn = (lambda name=name, dens=dens, light=light, n=n:
                  call(name, dens, light, n))
            plain = (lambda name=name, dens=dens, light=light, n=n:
                     call(name, dens, light, n, use_kernel=False))
            timing[(name, n)] = {
                "ms": cuda_ms(fn), "dev_us": dev_us(fn),
                "plain_ms": cuda_ms(plain), "plain_dev_us": dev_us(plain),
                "bound": bnd, "steps": n_steps}
            if parent is None:
                continue
            if name == pt_k.name and parent.point is None:
                print(f"phase 22b {name} {n}^3 frame: no parent kernel "
                      f"({state['parent']}'s light_sweep.cu has no X.5)")
                continue
            if name == pt_k.name:
                old = (lambda dens=dens, light=light, n=n:
                       parent.point(dens, light, n))
            else:
                old = (lambda ref=name == ref_k.name, dens=dens, light=light,
                       n=n: parent(ref, dens, light, n))
            e = max_err(old(), plain())
            res = turns.pairs_in_turns(old, fn, bnd[0], n_steps, SWEEP_PAIRS)
            print(f"phase 22b {name} {n}^3 frame, the kernel of "
                  f"{state['parent']} (max|err| {e:.3g} against the plain "
                  f"version) in turns with this tree's: {res['line']}; "
                  f"{card}")
    for (name, n), t in timing.items():
        lt = np.asarray(frames[n][1], np.float32)
        statics = {ref_k.name: lambda: rw.light_ref_statics(lt, n),
                   dir_k.name: lambda: rw.light_statics(lt),
                   pt_k.name: lambda: rw.point_light_statics(lt, n)}[name]()
        what = {ref_k.name: ", d0", dir_k.name: "",
                pt_k.name: ", sweep"}[name]
        print(f"phase 22b {name} at the {n}^3 frame's inputs (axis, flip"
              f"{what} {statics}): "
              f"{t['ms']:.4f} ms (CUDA events, {INNER} calls, median of "
              f"{REPS}); bound {t['bound'][0]:.6f} ms ({t['bound'][1]}); "
              f"{dev_text(t['dev_us'], t['bound'][0])}"
              f"{step_text(t['dev_us'], t['steps'])}; plain "
              f"{t['plain_ms']:.4f} ms, {dev_text(t['plain_dev_us'])}; "
              f"{card}")

    # ---- 22b-d. the -fast frames through the app ---------------------------
    with tempfile.TemporaryDirectory() as td:
        obj = Path(td) / "icosphere6.obj"
        v6, t6 = state["mesh6"]
        write_obj(obj, v6 * WORLD_SCALE + WORLD_CENTER, t6)
        launches, covered = app_run(
            torch, app_main, kernels,
            ["-mesh", os.path.relpath(obj), "-frames", str(FRAMES), "-fast"],
            Path(td) / "fast.png", "64^3 -fast app")
    check(launches[dir_k.name] == FRAMES and launches[ref_k.name] == 0
          and launches[pt_k.name] == 0,
          f"phase 22b -fast: {dir_k.name} launched {launches[dir_k.name]}, "
          f"{ref_k.name} {launches[ref_k.name]}, {pt_k.name} "
          f"{launches[pt_k.name]} times in {FRAMES} frames")
    print(f"phase 22b -fast app frames {GRID}^3 1280x720, {FRAMES} frames, "
          f"launches {launches}, volume covers {covered:.3f} of the image")

    # ---- 22b-e. the -pointlight frames: the app, then FramePipeline ------
    with tempfile.TemporaryDirectory() as td:
        for n, mesh, extra in ((GRID, state["mesh6"], []),
                               (GRID_HI, state["mesh7"],
                                ["-grid", str(GRID_HI)])):
            obj = Path(td) / f"point{n}.obj"
            write_obj(obj, mesh[0] * WORLD_SCALE + WORLD_CENTER, mesh[1])
            got, covered = app_run(
                torch, app_main, kernels,
                ["-mesh", os.path.relpath(obj), "-frames", str(FRAMES),
                 "-pointlight", *extra],
                Path(td) / "point.png", f"{n}^3 -pointlight app")
            check(got[pt_k.name] == FRAMES and got[ref_k.name] == 0
                  and got[dir_k.name] == 0,
                  f"phase 22b -pointlight {n}^3: {pt_k.name} launched "
                  f"{got[pt_k.name]}, {ref_k.name} {got[ref_k.name]}, "
                  f"{dir_k.name} {got[dir_k.name]} times in {FRAMES} frames")
            for k, c in got.items():
                launches[k] += c
            # the frames profiled in a process of their own, as the cells
            res = subprocess.run(
                [sys.executable, "-c", POINT_FRAMES, str(obj), str(n)],
                cwd=Path(__file__).resolve().parent,
                capture_output=True, text=True, timeout=CELL_TIMEOUT_S)
            lines = res.stdout.strip().splitlines()
            if res.returncode != 0 or not lines:
                print(res.stdout[-3000:], res.stderr[-6000:], file=sys.stderr)
                raise RuntimeError(f"phase 22b -pointlight {n}^3 frames "
                                   f"exited {res.returncode}")
            row = {k: (f"{v['ms']:.4f} ms a frame (CUDA events, {INNER} "
                       f"frames, median of {REPS}), device busy "
                       f"{v['busy_ms']:.4f} ms, {v['ops']:.0f} device ops, "
                       f"{pt_k.name} {v['x5_us']:.2f} us a frame")
                   for k, v in json.loads(lines[-1]).items()}
            print(f"phase 22b -pointlight {n}^3 1280x720 -hq: the app's "
                  f"{FRAMES} frames launch {got}, volume covers "
                  f"{covered:.3f} of the image; FramePipeline with the "
                  f"kernel: {row['kernel']}; with the sweep's plain version: "
                  f"{row['plain']}; {card}")
    print(f"phase 22b took {time.perf_counter() - t_start:.1f} s")
    t64 = {name: timing[(name, GRID)] for name in names}
    return {"launches": launches, "errs": errs,
            "ms": {k: (t["ms"], t["plain_ms"]) for k, t in t64.items()},
            "bounds": {k: t["bound"] for k, t in t64.items()}}


# phase 22b-e: the -pointlight frames through FramePipeline (argv: OBJ,
# grid), with the kernel and with the point sweep's plain version: ms
# (CUDA events), device busy ms, device ops and X.5's device us per frame
POINT_FRAMES = """
import json, sys
import torch
torch.backends.cuda.matmul.allow_tf32 = False
from dxrvoxelizer_tpu_torch.bench import cuda_ms, profile_frames
from dxrvoxelizer_tpu_torch.core import pipeline
from dxrvoxelizer_tpu_torch.core.pipeline import FramePipeline
from dxrvoxelizer_tpu_torch.models.camera import OrbitCamera
from dxrvoxelizer_tpu_torch.models.scene import Scene
from dxrvoxelizer_tpu_torch.ops import _cuda
from dxrvoxelizer_tpu_torch.utils.config import VoxelizerConfig
from dxrvoxelizer_tpu_torch.utils.objloader import load_obj
obj, n = sys.argv[1], int(sys.argv[2])
cfg = VoxelizerConfig(mesh=obj, grid_size=n, point_light=True)
scene = Scene(load_obj(obj), pos_scale=cfg.pos_scale,
              device=torch.device("cuda", 0), light_pt=cfg.light_pt)
cam = OrbitCamera(cfg.width, cfg.height)
consts = scene.update_frame(cam.eye, cam.view_proj, cfg.width, cfg.height)
pipe = FramePipeline(cfg, scene.buffers)
sweep = pipeline.light_sweep_point_host
def plain(density, light, n, **kw):
    return sweep(density, light, n, **{**kw, "use_kernel": False})
def frame():
    return pipe.frame(consts)
out = {}
for label, fn in (("kernel", sweep), ("plain", plain)):
    pipeline.light_sweep_point_host = fn
    frame()
    pipe.sync()
    ms = cuda_ms(frame)
    pipe.sync()
    busy, ops, kus = profile_frames(frame, pipe.sync, _cuda.all_kernels())
    out[label] = {"ms": ms, "busy_ms": busy, "ops": ops,
                  "x5_us": kus["light_sweep_point"]}
print(json.dumps(out))
"""

# ---- phase 22c: the grid glue's kernels (csrc/grid.cu) ----------------------
# frames of each cell driven with the launch counts set to 0 before and read
# after (after one frame that builds); the last one's grid and accel are
# the inputs held and timed
GLUE_FRAMES = 3
# FP32 operations a voxel of X.6, counted from csrc/grid.cu: rounded, a
# product, a rint and a product for each of the 4 channels; gated, the 3
# products of rgb by the bit. X.7 and X.8 do none (shifts and copies)
UNTILE_ROUND_OPS = 12
UNTILE_GATE_OPS = 3
# X.8 held at the mip sizes, sizes off its tiles and the frames' sizes
SLAB_SIZES = (8, 13, 40, GRID, 132, GRID_HI)


def untile_bound(n: int, src_bytes: int, quantize: bool, gated: bool,
                 words: bool, density: bool) -> tuple[float, str]:
    """X.6's least time: its input channels (``src_bytes``: the live tiles'
    or the grid's) and the 0.5 MiB slot map (tiled only) read once, the
    rgba written once, the words written (or a gate's read) and the density
    written once."""
    v = n ** 3
    b = src_bytes + v * 16 + (v // 8 if (words or gated) else 0)
    b += v * 4 if density else 0
    ops = v * ((UNTILE_ROUND_OPS if quantize else 0)
               + (UNTILE_GATE_OPS if gated else 0))
    return bound(b, ops)


def refit_rows_bound(verts, tris, normals) -> tuple[float, str]:
    """X.9's least time: the rows [T+1, 24] written once, the triangles'
    indices, the vertices and the normals read once."""
    t = int(tris.shape[0])
    return bound((t + 1) * 96 + tris.numel() * tris.element_size()
                 + verts.numel() * 4 + normals.numel() * 4, 0)


def merge_bound(accel, outs: dict, quantize: bool, gated: bool, words: bool,
                density: bool) -> tuple[float, str]:
    """X.10's least time: the ray -> slot map and each stream's outputs read
    once (the main stream's channels for the slots a ray maps to, padding
    slots unread, and their t and id only when the near-origin stream is
    merged; that stream's t, id and channels for its first n^3 lanes), then
    what X.6 writes."""
    v = accel.n ** 3
    b = 0
    if "main" in outs:
        read = int((accel.ray_slot >= 0).sum())
        b += v * 4 + read * (24 if "ov" in outs else 16)
    if "ov" in outs:
        b += v * 24
    return untile_bound(accel.n, b, quantize, gated, words, density)


def phase22c(torch, kernels, card, dev, state) -> dict:
    """Phase 22c: the grid glue's kernels (``csrc/grid.cu``,
    ``csrc/refit_rows.cu``): X.6 the grid's untiling, rounding and packing,
    X.7 the words' unpacking to density, X.8 the march's slab stack, X.9
    the refit's per-triangle rows, X.10 gen-6's stream merge with X.6's
    rounding and packing.

    a. Each cell of ``BENCHMARK.json`` (its Runner, as ``benchmark/run.py``
       drives it), and the app's 64^3 ``-inside raystab`` frame (gen-6,
       ``FramePipeline``): GLUE_FRAMES frames with every launch count set
       to 0 just before and read just after (B must launch X.6, X.8 and
       X.9 once a frame, A and C X.7 and X.8, the 64^3 ray-stab frame X.10
       and X.8, and no other glue kernel); then the last frame's grid and
       accel (``captured``) and B's refit inputs.
    b. Each kernel against its plain version with == (NaN at the same
       places) and bit for bit: X.6 on B's refitted accel (rounded and not;
       the words-gated ``-normals`` form on B's words under rule "hit"; the
       query's own untiling with the rounding off) and the tie set
       (``tests/torch_cases.quantize_cases``) in the tiled form; X.7 on A's and C's words; X.8 on every cell's density and
       light in all six (axis, flip) pairs, the frame's own pair among
       them, and on a strided density (an rgba grid's alpha); X.9 at B's
       refit (the 100,000-triangle torus, int64 and int32 triangles) and on
       the 64^3 and 256^3 icosphere; X.8 again at sizes 8, 13, 40, 64 and
       256 in all six (axis, flip) on a contiguous density, the strided
       alpha of an rgba grid and a density one float off a 16-byte boundary
       (each path of the kernel); X.10 on the 64^3 icosphere's gen-6 accel and on
       it with the near-origin soup (both streams), rounded and not, gated
       by the 64^3 parity words, on strided views of the sharded frames'
       packed pieces and without the near-origin stream, and the tie set in
       the grid-order form (an identity ray -> slot map).
    c. At each cell's inputs (X.10: the 64^3 ray-stab frame's): CUDA-event
       ms (INNER calls, median of REPS), device us per call (profiler),
       bound, plain ms and device us, launches a frame, and for X.8 the one
       PyTorch call that computes it (``torch.stack(...).contiguous()`` of
       the slab-order views).
    d. X.8 by marching axis at 64^3 and 256^3 (seeded volumes, no flip):
       device us, bound and share, and the stack call's device us; X.9 at
       B's refit and on the 256^3 icosphere (327,680 triangles), int64 and
       int32 triangles (the refitters hand it their int32 copy): device us,
       bound and share.

    ``state``: the 64^3 and 256^3 icospheres' configurations, buffers and
    constants,
    the near-origin soup and the test cases. Returns the cells' and the
    64^3 frame's launches (main paths), and for the result line each
    kernel's largest error, ms and plain ms, bound and library ms: X.6 and
    X.9 at B's frame, X.7 and X.8 at C's, X.10 at the 64^3 ray-stab
    frame's."""
    from benchmark.run import Runner, cell_from_spec, load_spec
    from dxrvoxelizer_tpu_torch.core.pipeline import FramePipeline, voxelize
    from dxrvoxelizer_tpu_torch.ops import grid_cuda as gc
    from dxrvoxelizer_tpu_torch.ops import raymarch_warp as rw
    from dxrvoxelizer_tpu_torch.ops import raystab_cuda as rsc
    from dxrvoxelizer_tpu_torch.ops import raystab_fast as rsf
    from dxrvoxelizer_tpu_torch.ops import raystab_tiled as rst
    from dxrvoxelizer_tpu_torch.ops.packing import (
        pack_bits_z,
        quantize_r10g10b10a2,
    )

    t_start = time.perf_counter()
    glue = {k.name: k for k in (gc.UNTILE, gc.UNPACK, gc.SLABS, gc.MERGE,
                                rsf.REFIT_ROWS)}
    errs = {k: 0.0 for k in glue}
    held_cases = {k: [] for k in glue}
    bit_diffs = {k: 0 for k in glue}

    def held(name, label, got, want):
        """got == want (tuples element by element; None pairs skipped)."""
        for g_, w_ in zip(got, want) if isinstance(got, tuple) else ((got, want),):
            if g_ is None and w_ is None:
                continue
            check(g_ is not None and w_ is not None
                  and tuple(g_.shape) == tuple(w_.shape)
                  and g_.dtype == w_.dtype,
                  f"phase 22c: {name} {label}: outputs differ in kind")
            if g_.dtype.is_floating_point:
                nan = torch.isnan(g_)
                ok = torch.equal(nan, torch.isnan(w_)) and torch.equal(
                    g_[~nan], w_[~nan])
                bit_diffs[name] += int((g_.view(torch.int32)
                                        != w_.view(torch.int32)).sum())
                if ok and bool((~nan).any()):
                    errs[name] = max(errs[name], max_err(g_[~nan], w_[~nan]))
            else:
                ok = torch.equal(g_, w_)
            check(ok, f"phase 22c: {name} {label} differs from its plain "
                  f"version")
        held_cases[name].append(label)

    # ---- 22c-a. the cells' frames --------------------------------------
    spec = load_spec()
    tmp = Path(tempfile.mkdtemp(prefix="dxv_glue_cells_"))
    atexit.register(shutil.rmtree, tmp, True)
    cells, launches = {}, {k.name: 0 for k in kernels}
    counts, sizes, rows_in = {}, {}, {}  # frames' launches, grids, X.9 inputs

    def glue_frames(c, step, inside, n, deform):
        """GLUE_FRAMES frames of ``step`` with the counts from 0 -> their
        launches, checked against the glue kernels the path must launch."""
        for k in kernels:
            k.launches = 0
        for _ in range(GLUE_FRAMES):
            out = step()
        torch.cuda.synchronize()
        got = {k.name: k.launches for k in kernels}
        for k, v in got.items():
            launches[k] += v
        stab = inside == "raystab"
        gen6 = stab and not rst.use_tiled_raystab(n)
        want = {"grid_slabs": GLUE_FRAMES,
                "grid_untile": GLUE_FRAMES if stab and not gen6 else 0,
                "grid_merge": GLUE_FRAMES if gen6 else 0,
                "grid_unpack": 0 if stab else GLUE_FRAMES,
                "refit_rows": GLUE_FRAMES if stab and deform else 0}
        check(all(got[k] == v for k, v in want.items()),
              f"phase 22c: {c}'s {GLUE_FRAMES} frames launched "
              f"{ {k: got[k] for k in glue} }, expected {want}")
        counts[c], sizes[c] = got, n
        return out

    for w in spec["workloads"]:
        c = w["name"]
        (tmp / c).mkdir()
        r = Runner(cell_from_spec(c, spec), 0, dev, tmp / c)
        pipe = r.pipeline()
        r.step(pipe)
        r.present()
        _, k_, consts = glue_frames(c, lambda r=r, pipe=pipe: r.step(pipe),
                                    r.cfg.inside_mode, r.cfg.grid_size,
                                    r.cell.deform)
        r.present()
        _, seen = r.rerun(pipe, k_, consts)
        if pipe._refitter is not None:  # the refit's inputs of that frame
            m = r.mesh_at(k_)
            # the refitter's own int32 copy, as every deforming frame
            rows_in[c] = (m.positions_norm, pipe._refitter._tris32, m.normals)
        cells[c] = (r, consts, seen["grid"], seen.get("accel"), counts[c])
    # the app's 64^3 -inside raystab frame (gen-6: X.10)
    cfg64, mb, consts64 = state["64"]
    stab6 = "gen-6 64^3 -inside raystab frame"
    pipe6 = FramePipeline(cfg64.replace(inside_mode="raystab"), mb)
    pipe6.frame(consts64)
    glue_frames(stab6, lambda: pipe6.frame(consts64), "raystab", GRID, False)
    pipe6.sync()

    # ---- 22c-b. the kernels against their plain versions ----------------
    timing = {}
    for c, (r, consts, grid, accel, _) in cells.items():
        n, cfg = r.cfg.grid_size, r.cfg
        if grid.rgba is None:
            held("grid_unpack", f"{c} words",
                 gc.unpack_density(grid.words, n),
                 gc.unpack_density_plain(grid.words, n))
            held("grid_unpack", f"{c} frame's density",
                 grid.density(), grid.density(use_kernel=False))
        if isinstance(accel, rst.RaystabAccel7):
            ns = rsc.fold_extract(accel.main, accel.t_count,
                                  rsf.INSIDE_THRESHOLD, "backface")[2]
            tiles = (accel.tids, accel.slots)
            for q in (True, False):
                k_ = gc.untile(ns, n, tiles=tiles, quantize=q)
                p_ = gc.untile(ns, n, tiles=tiles, quantize=q, use_kernel=False)
                held("grid_untile", f"{c} tiled{'' if q else ' unrounded'}",
                     k_, (p_[0], p_[1], p_[0][..., 3]))
            # the frame's own grid: the benchmark's hold 1 on the plain path
            occ_p, rgba_p = rst.raystab_query7(accel, use_kernels=False)
            held("grid_untile", f"{c} frame's grid",
                 (grid.words, grid.rgba, grid.density()),
                 (pack_bits_z(occ_p), quantize_r10g10b10a2(rgba_p),
                  quantize_r10g10b10a2(rgba_p)[..., 3]))
            held("grid_untile", f"{c} query's untiling (rounding off)",
                 rst.raystab_query7(accel),
                 rst.raystab_query7(accel, use_kernels=False))
            hit = rsc.fold_extract(accel.main, accel.t_count,
                                   rsf.INSIDE_THRESHOLD, "hit")[2]
            for q in (True, False):
                k_ = gc.untile(hit, n, tiles=tiles, gate=grid.words, quantize=q)
                p_ = gc.untile(hit, n, tiles=tiles, gate=grid.words,
                               quantize=q, use_kernel=False)
                held("grid_untile", f"{c} -normals gated{'' if q else ' unrounded'}",
                     k_, (p_[0], p_[1], p_[0][..., 3]))
            t_fn = lambda ns=ns, tiles=tiles, n=n: gc.untile(ns, n, tiles=tiles)  # noqa: E731
            t_plain = lambda ns=ns, tiles=tiles, n=n: gc.untile(  # noqa: E731
                ns, n, tiles=tiles, use_kernel=False)
            timing[("grid_untile", c)] = (t_fn, t_plain, None, untile_bound(
                n, ns.shape[0] * 128 * 16 + (n ** 3 // 128) * 4, True, False,
                True, True))
        # X.8 on the frame's density and light, all six (axis, flip)
        density = grid.density()
        s2l = np.asarray(consts.screen_to_local, np.float32)
        eye = np.asarray(consts.local_space_eye_pt, np.float32)
        axis, flip, _, _ = rw.shearwarp_statics(s2l, eye, cfg.width, cfg.height,
                                                m_cap=cfg.intermediate_cap)
        sweep = (rw.light_sweep_ref_host if cfg.render_ss > 1
                 else rw.light_sweep_host)
        light = sweep(density, consts.local_space_light_pt, n)
        for a in range(3):
            for f in (False, True):
                own = " (the frame's)" if (a, f) == (axis, bool(flip)) else ""
                held("grid_slabs", f"{c} axis {a} flip {f}{own}",
                     gc.slabs(density, light, a, f),
                     gc.slabs_plain(density, light, a, f))
        if grid.rgba is not None:
            held("grid_slabs", f"{c} strided rgba alpha",
                 gc.slabs(grid.rgba[..., 3], light, axis, flip),
                 gc.slabs_plain(grid.rgba[..., 3], light, axis, flip))
        perm = rw.perm_for_axis(axis)
        views = [rw._to_slab_order(v, perm, flip) for v in (density, light)]
        timing[("grid_slabs", c)] = (
            lambda d=density, lt=light, a=axis, f=flip: gc.slabs(d, lt, a, f),
            lambda d=density, lt=light, a=axis, f=flip: gc.slabs_plain(d, lt, a, f),
            lambda v=views: torch.stack(v).contiguous(),
            bound(16 * n ** 3, 0))
        if grid.rgba is None:
            timing[("grid_unpack", c)] = (
                lambda w=grid.words, n=n: gc.unpack_density(w, n),
                lambda w=grid.words, n=n: gc.unpack_density_plain(w, n), None,
                bound(n ** 3 // 8 + 4 * n ** 3, 0))

    # X.9 at B's refit and on the 64^3 icosphere (int64 and int32 triangles)
    mb7 = state["256"][1]
    rows_in[f"{GRID_HI}^3 icosphere"] = (mb7.positions_norm, mb7.tris,
                                         mb7.normals)
    for c, (v_, t_, n_) in [*rows_in.items(), (f"{GRID}^3 icosphere", (
            mb.positions_norm, mb.tris, mb.normals))]:
        want = rsf._fused_coef_matrix(v_, t_.to(torch.int64), n_)
        for tt in (t_.to(torch.int64), t_.to(torch.int32)):
            held("refit_rows", f"{c} {str(tt.dtype)[6:]} triangles",
                 rsf.fused_coef_matrix(v_, tt, n_), want)
        if c in cells:
            timing[("refit_rows", c)] = (
                lambda a=(v_, t_, n_): rsf.fused_coef_matrix(*a),
                lambda a=(v_, t_, n_): rsf._fused_coef_matrix(*a), None,
                refit_rows_bound(v_, t_, n_))
    # X.10 on the 64^3 icosphere's gen-6 accel (the frame's), and with the
    # near-origin soup (both streams): grid order and gated, the sharded
    # frames' packed pieces (strided views) and the main stream alone
    accel2 = rsf.build_raystab_accel2(mb.positions_norm, mb.tris, mb.normals,
                                      n=GRID)
    nv_, nn_, nt_ = (torch.from_numpy(np.asarray(a)).to(dev)
                     for a in state["near"])
    mbo = dataclasses.replace(
        mb, positions=torch.cat([mb.positions, nv_]),
        normals=torch.cat([mb.normals, nn_]),
        tris=torch.cat([mb.tris, nt_.long() + mb.positions.shape[0]]),
        positions_norm=torch.cat([mb.positions_norm, nv_]))
    accel2o = rsf.build_raystab_accel2(mbo.positions_norm, mbo.tris,
                                       mbo.normals, n=GRID)
    check(accel2o.main is not None and accel2o.ov is not None,
          "phase 22c: the icosphere + near-origin soup has not both streams")
    words64 = voxelize(mb, GRID).words

    for label, acc in ((f"gen-6 {GRID}^3", accel2),
                       (f"gen-6 {GRID}^3 + near-origin soup", accel2o)):
        for rule in ("backface", "hit"):
            outs = rsf._stream_outs2(acc, rsf.INSIDE_THRESHOLD, rule)
            forms = {"": outs, " packed": state["cases"].packed_outs(outs)}
            if len(outs) == 2:
                forms[" main stream alone"] = {"main": outs["main"]}
            for form, o in forms.items():
                for q in (True, False):
                    for g in (None, words64) if rule == "hit" else (None,):
                        k_ = gc.merge(acc, o, gate=g, quantize=q)
                        p_ = gc.merge_plain(acc, o, gate=g, quantize=q)
                        held("grid_merge", f"{label} {rule}{form}"
                             f"{' gated' if g is not None else ''}"
                             f"{'' if q else ' unrounded'}",
                             k_, (p_[0], p_[1], p_[0][..., 3]))
    for q in (True, False):  # the grid's entry point, both routes
        k_ = rsf.raystab_grid2(accel2, quantize=q)
        p_ = rsf.raystab_grid2(accel2, quantize=q, use_kernels=False)
        held("grid_merge", f"gen-6 {GRID}^3 raystab_grid2"
             f"{'' if q else ' unrounded'}", k_, (p_[0], p_[1], p_[0][..., 3]))
    outs6 = rsf._stream_outs2(accel2, rsf.INSIDE_THRESHOLD, "backface")
    timing[("grid_merge", stab6)] = (
        lambda: gc.merge(accel2, outs6), lambda: gc.merge_plain(accel2, outs6),
        None, merge_bound(accel2, outs6, True, False, True, True))
    del mbo, accel2o
    # the tie set, in every channel, in the tiled form (X.6) and the
    # grid-order form (X.10 through an identity ray -> slot map)
    cases = state["cases"]
    vals = torch.from_numpy(cases.quantize_cases())
    n_t = 32
    gen = torch.Generator().manual_seed(22)
    pick = torch.randint(0, vals.numel(), (n_t ** 3, 4), generator=gen)
    ch = vals[pick]
    ch[: vals.numel(), 0] = vals  # every case once in a channel of each kind
    ch[: vals.numel(), 3] = vals.flip(0)
    ch = ch.to(dev)
    gate = pack_bits_z(torch.rand((n_t,) * 3, generator=gen) < 0.5).to(dev)
    tids = torch.arange(n_t ** 3 // 128, device=dev)[::2].contiguous()
    tiles = (tids, gc.tile_slots(tids, n_t))
    ns_t = ch.reshape(-1, 128, 4)[: tids.numel()].contiguous()
    ident, ident_outs = cases.grid_order_streams(ch, n_t)
    for q in (True, False):
        for g in (None, gate):
            label = (f"{' gated' if g is not None else ''}"
                     f"{'' if q else ' unrounded'}")
            k_ = gc.untile(ns_t, n_t, tiles=tiles, gate=g, quantize=q)
            p_ = gc.untile(ns_t, n_t, tiles=tiles, gate=g, quantize=q,
                           use_kernel=False)
            held("grid_untile", f"tie set tiled{label}", k_,
                 (p_[0], p_[1], p_[0][..., 3]))
            k_ = gc.merge(ident, ident_outs, gate=g, quantize=q)
            p_ = gc.untile(ch, n_t, gate=g, quantize=q, use_kernel=False)
            held("grid_merge", f"tie set grid order{label}", k_,
                 (p_[0], p_[1], p_[0][..., 3]))
    # X.8 at every size of SLAB_SIZES on each of its paths' inputs
    for n in SLAB_SIZES:
        gen = torch.Generator(device=dev).manual_seed(n)
        rgba = torch.rand((n, n, n, 4), generator=gen, device=dev)
        light = torch.rand((n, n, n), generator=gen, device=dev)
        shifted = torch.rand(n ** 3 + 1, generator=gen, device=dev)[1:].view(
            n, n, n)
        for form, dens in (("contiguous", rgba[..., 3].contiguous()),
                           ("strided alpha", rgba[..., 3]),
                           ("off by a float", shifted)):
            for a in range(3):
                for f in (False, True):
                    held("grid_slabs", f"{n}^3 {form} ({a}, {int(f)})",
                         gc.slabs(dens, light, a, f),
                         gc.slabs_plain(dens, light, a, f))
        del rgba, light, shifted
    print(f"phase 22c the glue kernels against their plain versions (== with "
          f"NaN at the same places; max|err| {errs}, bits that differ "
          f"{bit_diffs}): " + "; ".join(
              f"{k} {len(v)} cases ({', '.join(v)})"
              for k, v in held_cases.items()) + f"; {card}")

    # ---- 22c-c. times and bounds at the cells' inputs ---------------------
    out_ms, out_bound, out_lib = {}, {}, {}
    pick_cell = {"grid_untile": "dragon256_raystab_wobble",
                 "grid_unpack": "dragon256_hq1080_orbit",
                 "grid_slabs": "dragon256_hq1080_orbit",
                 "refit_rows": "dragon256_raystab_wobble",
                 "grid_merge": stab6}
    for (name, c), (fn, plain, lib, bnd) in timing.items():
        ms = cuda_ms(fn)
        us = device_us(fn) or device_us(fn)
        plain_ms = cuda_ms(plain)
        plain_us = device_us(plain) or device_us(plain)
        lib_ms = cuda_ms(lib) if lib is not None else None
        lib_us = (device_us(lib) or device_us(lib)) if lib is not None else None
        per_frame = counts[c][name] / GLUE_FRAMES
        dev_text = (f"{us:.2f} us device per call, share {bnd[0] / (us / 1e3):.4f}"
                    if us else "device us not measured")
        lib_text = ("" if lib is None else
                    f"; library torch.stack(...).contiguous() {lib_ms:.4f} ms, "
                    f"{lib_us:.2f} us device")
        print(f"phase 22c {name} at {c}'s frame ({sizes[c]}^3): "
              f"{ms:.4f} ms (CUDA events, {INNER} calls, median of {REPS}), "
              f"{dev_text}; bound {bnd[0]:.6f} ms ({bnd[1]}); plain "
              f"{plain_ms:.4f} ms, {plain_us:.2f} us device{lib_text}; "
              f"{per_frame:g} launches a frame; {card}")
        if pick_cell[name] == c:
            out_ms[name] = (ms, plain_ms)
            out_bound[name] = bnd
            out_lib[name] = lib_ms

    # ---- 22c-d. X.8 by axis at 64^3 and 256^3; X.9 by mesh and width -----
    for n in (GRID, GRID_HI):
        gen = torch.Generator(device=dev).manual_seed(21 + n)
        dens = torch.rand((n, n, n), generator=gen, device=dev)
        light = torch.rand((n, n, n), generator=gen, device=dev)
        bnd = bound(16 * n ** 3, 0)
        for a in range(3):
            views = [rw._to_slab_order(v, rw.perm_for_axis(a), False)
                     for v in (dens, light)]
            fn = lambda d=dens, lt=light, a=a: gc.slabs(d, lt, a, False)  # noqa: E731
            lib = lambda v=views: torch.stack(v).contiguous()  # noqa: E731
            us = device_us(fn) or device_us(fn)
            lib_us = device_us(lib) or device_us(lib)
            path = gc.slab_path(0, gc._slab_strides(dens, a), n)
            dev_text = (f"{us:.2f} us device, share {bnd[0] / (us / 1e3):.4f}"
                        if us else "device us not measured")
            print(f"phase 22c X.8 {n}^3 axis {a} (path {path}): "
                  f"{cuda_ms(fn):.4f} ms, {dev_text}; bound {bnd[0]:.6f} ms "
                  f"({bnd[1]}); library torch.stack(...).contiguous() "
                  f"{cuda_ms(lib):.4f} ms, {lib_us:.2f} us device; {card}")
        del dens, light
    for c, (v_, t_, n_) in rows_in.items():
        yard = refit_rows_bound(v_, t_.to(torch.int64), n_)
        for tt in (t_.to(torch.int64), t_.to(torch.int32)):
            fn = lambda a=(v_, tt, n_): rsf.fused_coef_matrix(*a)  # noqa: E731
            us = device_us(fn) or device_us(fn)
            bnd = refit_rows_bound(v_, tt, n_)
            dev_text = (f"{us:.2f} us device, share {bnd[0] / (us / 1e3):.4f} "
                        f"({yard[0] / (us / 1e3):.4f} of the int64 bound)"
                        if us else "device us not measured")
            print(f"phase 22c X.9 {c} ({int(t_.shape[0]):,} triangles), "
                  f"{str(tt.dtype)[6:]} triangles: {cuda_ms(fn):.4f} ms, "
                  f"{dev_text}; bound {bnd[0]:.6f} ms ({bnd[1]}); {card}")
    print(f"phase 22c took {time.perf_counter() - t_start:.1f} s")
    extra = {c: sorted(glue[k].symbol for k in glue if counts[c][k])
             for c in cells}
    return {"launches": launches, "errs": errs, "ms": out_ms,
            "bounds": out_bound, "library": out_lib, "glue_by_cell": extra}


# the benchmark's cells (phase 23): 20 timed frames each, after 5 warm-up
CELL_FRAMES = 20
CELL_WARMUP = 5
CELL_TIMEOUT_S = 400


def phase23(root: Path, glue_by_cell: dict) -> None:
    """Run each cell of ``BENCHMARK.json`` for CELL_FRAMES timed frames;
    fail unless it exits 0 with ``correct`` true, every metric the file
    lists for it measured, and every roofline share at most 1.0.

    The grid glue's kernels (phase 22c) launch in the cells' frames, and
    ``BENCHMARK.json`` does not list them yet, so the runner's launch gate
    fails the cell (exit 1) for them. A cell passes that exits 1 with that
    gate's message alone, naming exactly the listed kernels and the glue
    kernels ``glue_by_cell`` saw in the cell's frames (phase 22c-a); any
    other failure fails."""
    from benchmark.run import cell_metrics, load_spec

    for cell in (w["name"] for w in load_spec()["workloads"]):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
             "0", "--frames", str(CELL_FRAMES), "--warmup", str(CELL_WARMUP)],
            cwd=root, capture_output=True, text=True, timeout=CELL_TIMEOUT_S)
        wall = time.perf_counter() - t0
        lines = res.stdout.strip().splitlines()
        line = json.loads(lines[-1]) if lines else {}
        listed = sorted(line.get("breakdown", {}).get("kernels", {}))
        extra = [p for p in glue_by_cell[cell] if p not in listed]
        gate = (f"hand kernels launched in the timed frames "
                f"{sorted(listed + extra)}, listed in BENCHMARK.json {listed}")
        unlisted = (res.returncode == 1 and bool(extra)
                    and line.get("failed") == gate)
        if not lines or (res.returncode != 0 and not unlisted):
            print(res.stdout[-4000:], res.stderr[-6000:], file=sys.stderr)
            raise RuntimeError(f"phase 23: {cell} exited {res.returncode}")
        if unlisted:
            print(f"phase 23 {cell}: exit 1 for the launch gate alone: "
                  f"{gate} (the glue kernels {extra} are not listed yet)")
        met = line["metrics"]
        missing = [k for k in cell_metrics(cell) if met.get(k) is None]
        shares = {k: v for k, v in met.items() if k.endswith("_roofline_share")}
        check(line["correct"] is True and not missing,
              f"phase 23: {cell} correct {line['correct']}, not measured "
              f"{missing}")
        check(shares and all(v <= 1.0 for v in shares.values()),
              f"phase 23: {cell} roofline shares {shares}")
        print(f"phase 23 {cell} in {wall:.1f} s: " + ", ".join(
            f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
            for k, v in met.items()))


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="The port's smoke run on the "
                                 "card (see the module's docstring).")
    ap.add_argument("--parent", default=None, help="a checkout of another "
                    "commit: phase 22b times its light-sweep kernel in turns "
                    "with this one's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_smoke = time.perf_counter()
    root = Path(__file__).resolve().parent
    if not (root / "dxrvoxelizer_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a repository checkout",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    # ray-stab accels are built through the on-disk accel cache (the app's
    # default): an empty one of this run's own, so every first build misses
    accel_cache_dir = tempfile.mkdtemp(prefix="dxv_accel_cache_")
    atexit.register(shutil.rmtree, accel_cache_dir, True)
    os.environ["DXRVOX_ACCEL_CACHE"] = accel_cache_dir
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from dxrvoxelizer_tpu_torch.app.main import wobbled
    from dxrvoxelizer_tpu_torch.app.main import main as app_main
    from dxrvoxelizer_tpu_torch.core.pipeline import (
        FramePipeline,
        VoxelGrid,
        render,
        voxelize,
    )
    from dxrvoxelizer_tpu_torch.models.camera import OrbitCamera
    from dxrvoxelizer_tpu_torch.models.scene import Scene
    from dxrvoxelizer_tpu_torch.ops import (
        _cuda,
        march_cuda,
        raystab_cuda,
        raystab_fast,
        raystab_mt_cuda,
        raystab_refit,
        raystab_tiled,
        screen_warp_cuda,
        voxelize_cuda,
        voxelize_queue,
        voxelize_queue_cuda,
    )
    from dxrvoxelizer_tpu_torch.ops.binning import (
        StaticBinnedVoxelizer,
        bin_triangles_spans,
    )
    from dxrvoxelizer_tpu_torch.ops.packing import (
        pack_bits_z,
        quantize_r10g10b10a2,
        unpack_bits_z,
    )
    from dxrvoxelizer_tpu_torch.ops.raymarch_warp import (
        light_sweep_ref_host,
        march_inputs,
        shearwarp_statics,
    )
    from dxrvoxelizer_tpu_torch.ops.voxelize_ref import (
        voxelize_parity_ref,
        voxelize_raystab_radial_ref,
        voxelize_raystab_ref,
    )
    from dxrvoxelizer_tpu_torch.utils import accel_cache, native
    from dxrvoxelizer_tpu_torch.utils.config import VoxelizerConfig
    from dxrvoxelizer_tpu_torch.utils.image import read_png
    from dxrvoxelizer_tpu_torch.utils.objloader import load_obj
    meshes = _load_test_module(root, "meshes")
    cases = _load_test_module(root, "torch_cases")
    box_mesh = meshes.box_mesh
    icosphere_mesh = meshes.icosphere_mesh
    tetrahedron_mesh = meshes.tetrahedron_mesh

    vq, vqc = voxelize_queue, voxelize_queue_cuda
    rsf, rsc, rmt = raystab_fast, raystab_cuda, raystab_mt_cuda
    kernels = _cuda.all_kernels()
    path_kernels = {  # the kernels each main path must launch
        "64": ("parity_voxelize", "grid_unpack", "light_sweep_ref",
               "grid_slabs", "march", "resolve"),
        "256": ("parity_queue", "grid_unpack", "light_sweep_ref", "grid_slabs",
                "march", "resolve"),
        "raystab": ("raystab_fold_extract", "grid_merge", "grid_slabs",
                    "march", "resolve"),
        "normals": ("parity_voxelize", "raystab_fold_extract", "grid_merge",
                    "grid_slabs", "march", "resolve"),
        "gen1": ("raystab_mt", "grid_slabs", "march", "resolve"),
    }
    dev = torch.device("cuda", 0)

    def once_per_frame(launches, name):
        for k in ("march", "resolve"):
            check(launches[k] == FRAMES, f"{name}: {k} launched "
                  f"{launches[k]} times in {FRAMES} frames, not once per frame")

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
    print(f"phase 1 gather kernels: "
          f"{gather_registers(info.log)}")
    native_builds = {}  # the native host tier, built before its first use
    for name in ("objparse", "pngwrite", "accelpack"):
        nb = native.build(name)
        check(nb is not None, f"the native {name} library did not build")
        native_builds[name] = nb.seconds
    print("phase 1 native build (g++, s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in native_builds.items()))

    main_launches = {k.name: 0 for k in kernels}
    with tempfile.TemporaryDirectory() as td:
        obj = Path(td) / "icosphere6.obj"
        v6, _, t6 = icosphere_mesh(6)
        write_obj(obj, v6 * WORLD_SCALE + WORLD_CENTER, t6)
        obj7 = Path(td) / "icosphere7.obj"
        v7, _, t7 = icosphere_mesh(7)
        write_obj(obj7, v7 * WORLD_SCALE + WORLD_CENTER, t7)
        # the CLI reads "/..." as a flag (reference-style prefixes)
        obj_arg, obj7_arg = os.path.relpath(obj), os.path.relpath(obj7)

        # ---- 2. the app's default frame (the main path) -----------------
        launches, covered = app_run(
            torch, app_main, kernels, ["-mesh", obj_arg, "-frames", str(FRAMES)],
            Path(td) / "frame.png", "64^3 app")
        for name in path_kernels["64"]:
            check(launches[name] > 0,
                  f"kernel {name} never launched on the 64^3 main path")
        once_per_frame(launches, "64^3 app")
        for k, c in launches.items():
            main_launches[k] += c
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

        # ---- 3b. the three 64^3 frames, timed before any other heavy phase
        cfg = VoxelizerConfig(mesh=str(obj))
        scene = Scene(load_obj(obj), pos_scale=cfg.pos_scale, device=dev,
                      light_pt=cfg.light_pt)
        mb = scene.buffers
        cam = OrbitCamera(cfg.width, cfg.height)
        consts = scene.update_frame(cam.eye, cam.view_proj, cfg.width,
                                    cfg.height)
        pipe = FramePipeline(cfg, mb)
        cfg_rs = cfg.replace(inside_mode="raystab")
        cfg_nm = cfg.replace(parity_normals=True)
        # first-frame latency (accel build + frame) as the process's first
        # ray-stab mesh pays it: the voxel->cell ray table is cached per
        # grid size, so it starts cold here and is warm for -normals
        rsf._ray_table_filled.cache_clear()
        first_s = {}
        for name, cfg_ in (("raystab", cfg_rs), ("normals", cfg_nm)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p_ = FramePipeline(cfg_, mb)
            f_ = p_.frame(consts)
            p_.sync()
            first_s[name] = (time.perf_counter() - t0, p_, f_)
        pipe_rs, f_rs = first_s["raystab"][1:]
        pipe_nm, f_nm = first_s["normals"][1:]

        def frame_kernels():
            return pipe.frame(consts)

        def frame_rs():
            return pipe_rs.frame(consts)

        def frame_nm():
            return pipe_nm.frame(consts)

        frames64 = {"parity": (frame_kernels, pipe),
                    "raystab": (frame_rs, pipe_rs),
                    "normals": (frame_nm, pipe_nm)}
        early = frames_in_turns(torch, frames64)
        print(f"phase 3b frames {GRID}^3 1280x720 -hq timed in turns first "
              f"(parity, raystab, normals, normals, raystab, parity; each a "
              f"median of {REPS} runs of {INNER}): "
              + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f} ms"
                          for k, v in early.items())
              + f"; first frame from a cold ray table (build + frame): "
              f"raystab {first_s['raystab'][0]:.4f} s, then -normals (warm "
              f"table) {first_s['normals'][0]:.4f} s; {card}")

        # ---- 6./7. the hi-res app frames (main paths of this slice) -------
        hi = {}
        for name, extra in (("static", []), ("deform", ["-deform"])):
            launches, covered = app_run(
                torch, app_main, kernels,
                ["-mesh", obj7_arg, "-grid", str(GRID_HI), "-frames",
                 str(FRAMES), *extra],
                Path(td) / f"hi_{name}.png", f"{GRID_HI}^3 {name} app")
            check(launches["parity_queue"] == FRAMES,
                  f"{name}: parity_queue launched {launches['parity_queue']} "
                  f"times in {FRAMES} frames")
            check(launches["parity_voxelize"] == 0,
                  f"{name}: the binned kernel ran at {GRID_HI}^3")
            for k in path_kernels["256"]:
                check(launches[k] >= FRAMES, f"{name}: {k} launched "
                      f"{launches[k]} times in {FRAMES} frames")
            once_per_frame(launches, f"{GRID_HI}^3 {name} app")
            for k, c in launches.items():
                main_launches[k] += c
            hi[name] = (launches, covered)

        # ---- 12./13. -inside raystab and -normals at 64^3 (main paths) ----
        stab_runs = {}
        for name, extra in (("raystab", ["-inside", "raystab"]),
                            ("normals", ["-normals"])):
            launches, covered = app_run(
                torch, app_main, kernels,
                ["-mesh", obj_arg, "-frames", str(FRAMES), *extra],
                Path(td) / f"{name}.png", f"{GRID}^3 {name} app")
            for k in path_kernels[name]:
                check(launches[k] >= FRAMES, f"{name}: {k} launched "
                      f"{launches[k]} times in {FRAMES} frames")
            once_per_frame(launches, f"{GRID}^3 {name} app")
            if name == "raystab":
                check(launches["parity_voxelize"] == 0
                      and launches["parity_queue"] == 0,
                      f"raystab: a parity kernel ran: {launches}")
            for k, c in launches.items():
                main_launches[k] += c
            stab_runs[name] = (launches, covered)

        # ---- 17. the reference's inside rule at 256^3 (gen-7) and on
        # deforming meshes (the refitters), through the app (main paths)
        new_runs = {}
        for name, grid, extra in (
                ("raystab 256", GRID_HI, ["-inside", "raystab"]),
                ("normals 256", GRID_HI, ["-normals"]),
                ("raystab 256 -deform", GRID_HI, ["-inside", "raystab", "-deform"]),
                ("normals 256 -deform", GRID_HI, ["-normals", "-deform"]),
                ("raystab 64 -deform", GRID, ["-inside", "raystab", "-deform"]),
                ("normals 64 -deform", GRID, ["-normals", "-deform"])):
            t0 = time.perf_counter()
            launches, covered = app_run(
                torch, app_main, kernels,
                ["-mesh", obj7_arg, "-grid", str(grid), "-frames", str(FRAMES),
                 *extra], Path(td) / f"{name.replace(' ', '_')}.png", name)
            secs = time.perf_counter() - t0
            parity = name.startswith("normals")
            gen6 = grid == GRID  # X.10 merges gen-6's streams, X.6 gen-7's
            want = {"raystab_fold_extract": FRAMES,
                    "grid_untile": 0 if gen6 else FRAMES,
                    "grid_merge": FRAMES if gen6 else 0,
                    "grid_slabs": FRAMES, "grid_unpack": 0,
                    "parity_queue": FRAMES if parity and grid == GRID_HI else 0,
                    "parity_voxelize": FRAMES if parity and grid == GRID else 0}
            for k, c in want.items():
                check(launches[k] == c, f"{name}: {k} launched {launches[k]} "
                      f"times in {FRAMES} frames, expected {c}")
            if "-deform" in extra:  # the refit's rows (X.9) every frame
                check(launches["refit_rows"] >= FRAMES, f"{name}: refit_rows "
                      f"launched {launches['refit_rows']} times in {FRAMES} "
                      "frames")
            once_per_frame(launches, name)
            for k, c in launches.items():
                main_launches[k] += c
            new_runs[name] = (launches, covered, secs)

        # the hi-res path's state, rebuilt for the comparisons
        cfg_hi = VoxelizerConfig(mesh=str(obj7), grid_size=GRID_HI)
        scene7 = Scene(load_obj(obj7), pos_scale=cfg_hi.pos_scale, device=dev,
                       light_pt=cfg_hi.light_pt)
    for phase, name in ((6, "static"), (7, "deform")):
        launches, covered = hi[name]
        print(f"phase {phase} app frame {name}: {len(t7)} tris {GRID_HI}^3 "
              f"1280x720 -hq{' -deform' if name == 'deform' else ''}, "
              f"{FRAMES} frames, launches {launches}, volume covers "
              f"{covered:.3f} of the image")
    for phase, name in ((12, "raystab"), (13, "normals")):
        launches, covered = stab_runs[name]
        print(f"phase {phase} app frame {name}: {len(t6)} tris {GRID}^3 "
              f"1280x720 -hq {'-inside raystab' if name == 'raystab' else '-normals'}, "
              f"{FRAMES} frames, launches {launches}, volume covers "
              f"{covered:.3f} of the image")
    for name, (launches, covered, secs) in new_runs.items():
        print(f"phase 17 app frame {name}: {len(t7)} tris 1280x720 -hq, "
              f"{FRAMES} frames, {secs:.2f} s for the whole app run (load, "
              f"accel build or refitter, frames), launches {launches}, volume "
              f"covers {covered:.3f} of the image")

    # ---- 4. kernels against their plain versions ------------------------
    errs = {}

    def dev_mesh(verts, tris):
        return (torch.from_numpy(np.asarray(verts, np.float32)).to(dev),
                torch.from_numpy(np.asarray(tris, np.int64)).to(dev))

    def parity_tiles_case(name, coef, spans, counts, n):
        """Kernel 2.1 on one set of tiles against its plain version (every
        column of every row): the main path and every layout of the sweep."""
        plain = voxelize_cuda.voxelize_parity_tiles_plain(coef, n)
        for variant in [None, *cases.PARITY_VARIANTS]:
            sp = None if variant and variant[0] == "column" else spans
            words = voxelize_cuda.voxelize_parity_tiles(
                coef, n, spans=sp, counts=counts, variant=variant)
            check(torch.equal(words, plain), f"parity words ({variant}) "
                  f"differ from the plain version: {name} {n}^3")
        check(bool(plain.any()), f"{name} {n}^3: empty grid")

    def parity_case(name, verts, tris, n):
        mb_ = torch.from_numpy(np.asarray(verts, np.float32)).to(dev)
        tr = torch.from_numpy(np.asarray(tris, np.int64)).to(dev)
        coef, spans, counts, stats = bin_triangles_spans(mb_, tr, n)
        parity_tiles_case(name, coef, spans, counts, n)
        return stats

    def box_on_centers(n):
        c = [(i + 0.5) / n * 2 - 1 for i in (3, 5, 2, n - 6, n - 4, n - 9)]
        return box_mesh(c[:3], c[3:])  # faces on voxel centers: ties

    box_lines = []
    parity_meshes = [("icosphere6", GRID, v6, t6), ("icosphere6", 256, v6, t6)]
    parity_meshes += [("box_on_centers", n, *box_on_centers(n)[::2])
                      for n in (32, GRID, 256)]
    parity_meshes += [(f"needle_soup{seed}", GRID, *cases.needle_soup(
        np.random.default_rng(seed), GRID, cases.SOUP_TRIS))
        for seed in cases.SOUP_SEEDS]
    for name, n, vv, tt in parity_meshes:
        stats = parity_case(name, vv, tt, n)
        box_lines.append(f"{name}@{n}^3 cap {stats.capacity}")
    # the brute-force path: every triangle in every tile
    for name, (vv, tt) in (("icosphere6", (mb.positions_norm, mb.tris)),
                           ("box_on_centers", dev_mesh(*box_on_centers(GRID)[::2]))):
        tiles_bf, spans_bf = voxelize_cuda.bruteforce_tiles(vv, tt, GRID)
        parity_tiles_case(f"bruteforce {name}", tiles_bf, spans_bf, None, GRID)
        check(torch.equal(voxelize_cuda.voxelize_parity_bruteforce(vv, tt, GRID),
                          voxelize_cuda.voxelize_parity_tiles_plain(tiles_bf, GRID)),
              f"bruteforce {name}: the path differs from the plain version")
        box_lines.append(f"bruteforce {name}@{GRID}^3 {tiles_bf.shape[1]} rows")
    # and the main path's kernel against the independent counting oracle
    oracle = pack_bits_z(voxelize_parity_ref(mb.positions_norm, mb.tris, n=GRID))
    sb_main = StaticBinnedVoxelizer(mb.positions_norm, mb.tris, GRID)
    coef_main, stats_main = sb_main.coef_tiles, sb_main.stats
    words_main = sb_main()
    check(torch.equal(words_main, oracle), "kernel words differ from the oracle")
    errs["parity_voxelize"] = 0.0
    phase4 = [f"parity words bit-identical to the plain version at the main "
              f"path's settings and every layout of the sweep "
              f"{cases.PARITY_VARIANTS} ({', '.join(box_lines)}) and to the "
              f"counting oracle at {GRID}^3 (main path: {stats_main})"]

    def resolve_case(s_i, t_i, consts_, cfg_, statics, mi_):
        """The fused resolve against screen_coords + resolve_plain: the
        coordinates and hit mask bit for bit, the image within TOL_RESOLVE
        -> (resolve args, image error)."""
        axis, flip, swap = statics
        args = (s_i, t_i, consts_.screen_to_local, consts_.local_space_eye_pt,
                np.asarray(cfg_.clear_color, np.float32), cfg_.width,
                cfg_.height, axis, flip, swap, mi_)
        got = screen_warp_cuda.resolve_screen(*args, coords=True)
        want = screen_warp_cuda.resolve_screen_plain(*args)
        for what, a, b in zip(("gi_x", "gi_y", "ok"), got[1:], want[1:]):
            check(torch.equal(a, b), f"resolve {what} differs from "
                  f"screen_coords (flip={flip}, swap={swap})")
        err = max_err(got[0], want[0])
        check(err <= TOL_RESOLVE, f"resolve differs by {err:.3g} (flip="
              f"{flip}, swap={swap})")
        return args, err

    def render_case(words, consts_, cfg_, n, ss_list, scene_):
        """March and resolve against their plain versions at the inputs
        the frame gives them, the resolve also on the ORBIT_YAWS cameras ->
        (march inputs, resolve args, march error per ss, resolve error, m,
        swap, the (flip, swap) the cameras set, (density, light))."""
        density = VoxelGrid(words=words).density()
        light = light_sweep_ref_host(density, consts_.local_space_light_pt, n)
        axis, flip, swap, m = shearwarp_statics(
            consts_.screen_to_local, consts_.local_space_eye_pt, cfg_.width,
            cfg_.height, m_cap=cfg_.intermediate_cap,
        )
        m_err = {}
        for ss in ss_list:
            mi_ss = march_inputs(density, light, consts_.local_space_eye_pt,
                                 n, m, axis, flip, ss)
            t_k, s_k = march_cuda.march(*mi_ss.args(),
                                        ring=mi_ss.ring)
            t_p, s_p = march_cuda.march_plain(*mi_ss.args())
            m_err[ss] = max(max_err(t_k, t_p), max_err(s_k, s_p))
            check(m_err[ss] <= TOL_MARCH,
                  f"march {n}^3 ss={ss} differs by {m_err[ss]:.3g}")
        mi_ = march_inputs(density, light, consts_.local_space_eye_pt, n, m,
                           axis, flip, cfg_.render_ss)
        t_i, s_i = march_cuda.march(*mi_.args(), ring=mi_.ring)
        args, r_err = resolve_case(s_i, t_i, consts_, cfg_,
                                   (axis, flip, swap), mi_)
        seen = set()
        for yaw in ORBIT_YAWS:
            cam_o = OrbitCamera(cfg_.width, cfg_.height)
            if yaw:
                cam_o.orbit(yaw, 0.0)
            c_o = scene_.update_frame(cam_o.eye, cam_o.view_proj, cfg_.width,
                                      cfg_.height)
            a_o, f_o, sw_o, m_o = shearwarp_statics(
                c_o.screen_to_local, c_o.local_space_eye_pt, cfg_.width,
                cfg_.height, m_cap=cfg_.intermediate_cap)
            mi_o = march_inputs(density, light, c_o.local_space_eye_pt, n,
                                m_o, a_o, f_o, cfg_.render_ss)
            t_o, s_o = march_cuda.march(*mi_o.args(), ring=mi_o.ring)
            r_err = max(r_err, resolve_case(s_o, t_o, c_o, cfg_,
                                            (a_o, f_o, sw_o), mi_o)[1])
            seen.add((f_o, sw_o))
        check(any(f for f, _ in seen) and any(w for _, w in seen),
              f"the orbit cameras set no flip or no swap: {seen}")
        return mi_, args, m_err, r_err, m, swap, sorted(seen), (density, light)

    mi, res_args, march_err, res_err, m, swap, seen, vols = render_case(
        words_main, consts, cfg, GRID, (1, 2), scene)
    errs["march"] = max(march_err.values())
    errs["resolve"] = res_err
    phase4.append(f"march max|err| ss=1 {march_err[1]:.3g} ss=2 "
                  f"{march_err[2]:.3g} (m={m}, swap={swap}, ring "
                  f"{mi.ring}); resolve gi_x/gi_y/ok bit-identical to "
                  f"screen_coords and image max|err| {errs['resolve']:.3g} on "
                  f"the frame's camera and {len(ORBIT_YAWS)} orbit cameras "
                  f"(flip, swap) {seen}")

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
            cuda_ms(sb_main),
            cuda_ms(lambda: voxelize_cuda.voxelize_parity_tiles_plain(coef_main, GRID)),
        ),
        "march": (
            cuda_ms(lambda: march_cuda.march(*mi.args(),
                                                    ring=mi.ring)),
            cuda_ms(lambda: march_cuda.march_plain(*mi.args())),
        ),
        "resolve": (
            cuda_ms(lambda: screen_warp_cuda.resolve_screen(*res_args)),
            cuda_ms(lambda: screen_warp_cuda.resolve_screen_plain(*res_args)),
        ),
    }
    gs = grid_sample_call(torch, res_args)
    dev_us = {  # device time per call (profiler)
        "march": device_us(lambda: march_cuda.march(
            *mi.args(), ring=mi.ring)),
        "resolve": device_us(
            lambda: screen_warp_cuda.resolve_screen(*res_args)),
        "grid_sample": device_us(gs),
    }
    # the resolve wrapper's host time per call beside one elementwise torch
    # op's (a multiplication by a CPU scalar, as in screen_coords)
    wrap_host_us = host_us(torch, lambda: screen_warp_cuda.resolve_screen(*res_args))
    op_host_us = host_us(torch, lambda: torch.mul(res_args[0], 0.8))
    empty_host_us = host_us(torch, lambda: torch.empty(
        (cfg.height, cfg.width, 3), dtype=torch.float32, device=dev))
    # the march set-up's host time per frame (march_inputs as the frame
    # calls it) and that of the ring sizing inside it (march_ring on the CPU
    # tensors march_inputs hands it), the host cost of the kernel's
    # shared-memory ring
    axis, flip = res_args[7], res_args[8]
    eye = consts.local_space_eye_pt
    mi_host_us = host_us(torch, lambda: march_inputs(
        *vols, eye, GRID, m, axis, flip, cfg.render_ss), calls=50)
    ring_in = [t.cpu() for t in (mi.scale_x, mi.off_x, mi.scale_y, mi.off_y)]
    ring_host_us = host_us(torch, lambda: march_cuda.march_ring(
        *ring_in, m, GRID, cfg.render_ss))
    frame_ms = cuda_ms(frame_kernels)
    pipe.sync()
    frame_plain_ms = cuda_ms(frame_plain)

    library_ms = {"resolve": cuda_ms(gs)}

    # device time by kernel over a steady window of frames (profiler): what
    # the card is busy with per frame, and how long it idles
    torch.cuda.reset_peak_memory_stats()
    busy_ms, per_frame, kernel_us = profile_frames(frame_kernels, pipe.sync,
                                                   kernels)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    print(f"phase 5 frame {GRID}^3 1280x720 -hq: {frame_ms:.4f} ms with the "
          f"kernels, {frame_plain_ms:.4f} ms plain (CUDA events over "
          f"{INNER} back-to-back runs, median of {REPS}); profiled: device "
          f"busy {busy_ms:.4f} ms per frame (idle share "
          f"{1 - busy_ms / frame_ms:.3f}), {per_frame:.0f} device "
          f"kernels and copies per frame, kernel device us per frame "
          f"{kernel_us}, peak device memory {peak_mib:.1f} MiB; {card}")
    print(f"phase 5 at the {GRID}^3 frame's inputs (m={m}, "
          f"{mi.slabs.shape[1] * mi.ss} sub-slabs): march "
          f"{ms['march'][0]:.4f} ms, {dev_us['march']:.2f} us device per "
          f"call; resolve {ms['resolve'][0]:.4f} ms, {dev_us['resolve']:.2f} "
          f"us device per call; grid_sample {library_ms['resolve']:.4f} ms, "
          f"{dev_us['grid_sample']:.2f} us device per call; resolve wrapper "
          f"host {wrap_host_us:.2f} us per call, one torch.mul "
          f"{op_host_us:.2f} us, one torch.empty of the image "
          f"{empty_host_us:.2f} us; march set-up (march_inputs) host "
          f"{mi_host_us:.2f} us per frame, of which the ring sizing "
          f"(march_ring) {ring_host_us:.2f} us; {card}")

    # ---- 5c. kernel 2.1's layouts at the 64^3 frame's bins ---------------
    flush = torch.empty(1 << 24, dtype=torch.float32, device=dev)  # 64 MiB > L2
    sp_main, ct_main = sb_main.spans, sb_main.counts
    p_fns = {variant: (lambda variant=variant: voxelize_cuda.voxelize_parity_tiles(
        coef_main, GRID, spans=None if variant[0] == "column" else sp_main,
        counts=ct_main, variant=variant)) for variant in cases.PARITY_VARIANTS}
    # the parent's work: every column of every row, padding included
    p_fns["parent (column, no counts)"] = (
        lambda: voxelize_cuda.voxelize_parity_tiles(coef_main, GRID))
    p_sweep = time_sweep(torch, p_fns)
    p_dev_us = device_us(sb_main)
    p_cold_us = {k: cold_device_us(torch, fn, flush)
                 for k, fn in [("main", sb_main), *p_fns.items()]}
    p_rows, p_pairs = binned_tested_pairs(torch, voxelize_cuda, coef_main,
                                          sp_main, ct_main, GRID)
    p_host_us = host_us(torch, sb_main)  # the wrapper's host time per call
    pairs_b = bbox_pairs(torch, mb.positions_norm, mb.tris, GRID)
    print(f"phase 5c binned parity kernel at the {GRID}^3 frame's bins "
          f"({tuple(coef_main.shape)}, {stats_main}): main path "
          f"{ms['parity_voxelize'][0]:.4f} ms, {p_dev_us:.2f} us device per "
          f"call, wrapper host {p_host_us:.2f} us per call; rows walked "
          f"{p_rows} of {coef_main.shape[0] * coef_main.shape[1]}, (column, "
          f"row) pairs tested {p_pairs} (parent: every column of every row, "
          f"{coef_main.shape[0] * coef_main.shape[1] * 1024}), needed "
          f"{pairs_b}; layouts ((layout, blocks per tile, threads): CUDA-event ms, "
          f"profiler device us per call): " + ", ".join(
              f"{v} {t[0]:.4f} ms {t[1]:.2f} us" for v, t in p_sweep.items())
          + "; with the L2 flushed before each call (device us): " + ", ".join(
              f"{v} {us:.2f}" for v, us in p_cold_us.items()) + f"; {card}")

    # ---- 5b. the march across intermediate sizes and sub-slab counts -----
    # at the 64^3 frame's inputs, M = 64 to 512 and ss = 1, 2 (KS = 64,
    # 128): a latency chain per step shows as time that follows KS and stays
    # flat in M while M^2 threads underfill the card
    sweep = []
    for ss in (1, 2):
        for m_s in (64, 128, 256, 512):
            mi_s = march_inputs(*vols, eye, GRID, m_s, axis, flip, ss)

            def march_s(mi_s=mi_s):
                return march_cuda.march(*mi_s.args(), ring=mi_s.ring)

            sweep.append(f"M={m_s} KS={GRID * ss} ring {mi_s.ring} "
                         f"{cuda_ms(march_s):.4f} ms "
                         f"{device_us(march_s):.2f} us")
    print(f"phase 5b march at the {GRID}^3 frame's inputs (CUDA-event ms and "
          f"profiler device us per call): " + "; ".join(sweep) + f"; {card}")

    # ---- 8. the deforming call is sync-free ------------------------------
    mb7 = scene7.buffers
    base_x = mb7.positions_norm[:, :1].cpu().numpy()
    dv = vq.DeformingVoxelizer(mb7.positions_norm, mb7.tris, GRID_HI)
    wob = [wobbled(mb7, base_x, f).positions_norm for f in (1, 2, 3)]
    dv(wob[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        words_sync_free = dv(wob[1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(bool(words_sync_free.any()), "the deforming call voxelized nothing")
    print(f"phase 8 DeformingVoxelizer.__call__ at {GRID_HI}^3 ran under "
          f"set_sync_debug_mode('error') without a host sync (capacity "
          f"{dv.num_chunks} chunks, span caps {dv.spans})")

    # ---- 9. the work-queue kernel against its plain version --------------
    def queue_variants(name, coefs, sp, ct, cn, n, want):
        """Every layout and block size of the sweep, with the spans and
        without (every row against its whole tile), against ``want``."""
        for variant in cases.QUEUE_VARIANTS:
            for sp_ in (sp, None):
                got = vqc.voxelize_parity_queue_chunks(coefs, ct, cn, n,
                                                       spans=sp_, variant=variant)
                check(torch.equal(got, want), f"queue variant {variant} (spans "
                      f"{sp_ is not None}) differs from plain: {name} {n}^3")

    def queue_case(name, verts, tris, n, oracle=False, **spans):
        coefs, sp, ct, cn, _, stats = vq.build_queue(verts, tris, n, **spans)
        words = vqc.voxelize_parity_queue_chunks(coefs, ct, cn, n, spans=sp)
        plain = vqc.voxelize_parity_queue_chunks_plain(coefs, ct, cn, n)
        check(torch.equal(words, plain),
              f"queue words differ from the plain version: {name} {n}^3")
        queue_variants(name, coefs, sp, ct, cn, n, plain)
        check(torch.equal(words, StaticBinnedVoxelizer(verts, tris, n)()),
              f"queue words differ from the binned kernel's: {name} {n}^3")
        if oracle:
            ref = pack_bits_z(voxelize_parity_ref(verts, tris, n=n))
            check(torch.equal(words, ref),
                  f"queue words differ from the oracle: {name} {n}^3")
        check(bool(words.any()), f"{name} {n}^3: empty grid")
        return f"{name}@{n}^3 {stats.real_chunks} chunks {stats.pairs} pairs " \
               f"{stats.overflow} overflow"

    q_lines = []
    for n in (128, 256, 512):
        q_lines.append(queue_case("icosphere7", mb7.positions_norm, mb7.tris,
                                  n, oracle=n == 128))
        q_lines.append(queue_case("box_on_centers", *dev_mesh(*box_on_centers(n)[::2]),
                                  n, oracle=n == 128))
    q_lines.append(queue_case("box_on_centers", *dev_mesh(*box_on_centers(256)[::2]),
                              256, max_span_x=1, max_span_y=1))
    v4, _, t4 = icosphere_mesh(4)
    q_lines.append(queue_case("icosphere4", *dev_mesh(v4, t4), 128, oracle=True,
                              max_span_x=1, max_span_y=1))
    # 512^3 with overflow rows: the box's two z faces (4 triangles; the
    # others project to lines) span more tiles than the caps and are appended
    # to every tile
    vb5, _, tb5 = box_on_centers(512)
    q_lines.append(queue_case(
        "icosphere7+box_on_centers",
        torch.cat([mb7.positions_norm, dev_mesh(vb5, tb5)[0]]),
        torch.cat([mb7.tris, dev_mesh(vb5, tb5)[1] + mb7.positions_norm.shape[0]]),
        512))
    check(q_lines[-1].endswith(" 4 overflow"), f"expected 4 overflow "
          f"triangles: {q_lines[-1]}")
    for f, w in enumerate(wob[1:], 2):
        coefs, sp, ct, cn, _, ok_d = dv.build(w)
        check(bool(ok_d), f"deformed frame {f} overflowed its capacity")
        words = vqc.voxelize_parity_queue_chunks(coefs, ct, cn, GRID_HI,
                                                 spans=sp)
        plain = vqc.voxelize_parity_queue_chunks_plain(coefs, ct, cn, GRID_HI)
        check(torch.equal(words, plain), f"deformed frame {f}: kernel != plain")
        queue_variants(f"deformed frame {f}", coefs, sp, ct, cn, GRID_HI, plain)
        check(torch.equal(words, vq.voxelize_parity_queue(w, mb7.tris, GRID_HI)),
              f"deformed frame {f}: device-built queue != host-built queue")
        q_lines.append(f"deformed frame {f}@{GRID_HI}^3")
    check(torch.equal(words_sync_free, dv(wob[1])), "deforming call not repeatable")
    errs["parity_queue"] = 0.0
    print("phase 9 queue words bit-identical to the plain version and to the "
          "binned kernel (" + "; ".join(q_lines) + "), to the counting oracle "
          f"at 128^3; every layout and block size of the sweep "
          f"{cases.QUEUE_VARIANTS}, with and without column spans, bit-identical "
          "to the plain version on each")

    # ---- 10. the 256^3 frame against the plain path ----------------------
    cam7 = OrbitCamera(cfg_hi.width, cfg_hi.height)
    consts7 = scene7.update_frame(cam7.eye, cam7.view_proj, cfg_hi.width,
                                  cfg_hi.height)
    pipe7 = FramePipeline(cfg_hi, mb7)
    sv = vq.StaticVoxelizer(mb7.positions_norm, mb7.tris, GRID_HI)

    def frame7_kernels():
        return pipe7.frame(consts7)

    def frame7_plain():
        words = vqc.voxelize_parity_queue_chunks_plain(
            sv.coefs, sv.chunk_tile, sv.chunk_nsub, GRID_HI)
        return render(VoxelGrid(words=words), consts7, cfg_hi, use_kernels=False)

    f7_k = frame7_kernels()
    pipe7.sync()
    f7_p = frame7_plain()
    frame7_err = max_err(f7_k, f7_p)
    check(bool(torch.isfinite(f7_k).all()) and f7_k.shape == (720, 1280, 3),
          "256^3 frame not finite or misshapen")
    check(frame7_err <= TOL_FRAME, f"256^3 frame differs by {frame7_err:.3g}")
    mi7, res_args7, march_err7, res_err7, m7, swap7, seen7, vols7 = render_case(
        sv(), consts7, cfg_hi, GRID_HI, (cfg_hi.render_ss,), scene7)
    errs["march"] = max(errs["march"], march_err7[cfg_hi.render_ss])
    errs["resolve"] = max(errs["resolve"], res_err7)
    print(f"phase 10 frame {GRID_HI}^3 1280x720 -hq max|err| kernels vs plain "
          f"{frame7_err:.3g} (queue {sv.stats}); at its own inputs march "
          f"max|err| ss={cfg_hi.render_ss} "
          f"{march_err7[cfg_hi.render_ss]:.3g} (m={m7}, swap={swap7}, ring "
          f"(chunk slabs, rows, columns) {mi7.ring}), resolve gi_x/gi_y/ok bit-identical to "
          f"screen_coords and image max|err| {res_err7:.3g} on the frame's "
          f"camera and the orbit cameras (flip, swap) {seen7}")

    # ---- 11. hi-res timings ----------------------------------------------
    sv512 = vq.StaticVoxelizer(mb7.positions_norm, mb7.tris, 512)
    ms["parity_queue"] = (
        cuda_ms(sv),
        cuda_ms(lambda: vqc.voxelize_parity_queue_chunks_plain(
            sv.coefs, sv.chunk_tile, sv.chunk_nsub, GRID_HI)),
    )
    q512_ms = (
        cuda_ms(sv512),
        cuda_ms(lambda: vqc.voxelize_parity_queue_chunks_plain(
            sv512.coefs, sv512.chunk_tile, sv512.chunk_nsub, 512)),
    )
    q_dev_us = {GRID_HI: device_us(sv), 512: device_us(sv512)}
    q_pairs = {n_: queue_tested_pairs(torch, vqc, v_.coefs, v_.spans,
                                      v_.chunk_tile, v_.chunk_nsub, n_)
               for n_, v_ in ((GRID_HI, sv), (512, sv512))}
    q_needed = {n_: bbox_pairs(torch, mb7.positions_norm, mb7.tris, n_)
                for n_ in (GRID_HI, 512)}
    sb7 = StaticBinnedVoxelizer(mb7.positions_norm, mb7.tris, GRID_HI)
    stats_b7 = sb7.stats
    binned256_ms = cuda_ms(sb7)
    deform_call_ms = cuda_ms(lambda: dv(wob[2]))
    pipe7d = FramePipeline(cfg_hi, mb7, deforming=True)
    pipe7d.mesh = wobbled(mb7, base_x, 2)

    def frame7_deform():
        return pipe7d.frame(consts7)

    render7 = {  # kernel ms, plain ms, bound at the 256^3 frame's inputs
        "march": (cuda_ms(lambda: march_cuda.march(
            *mi7.args(), ring=mi7.ring)),
                  cuda_ms(lambda: march_cuda.march_plain(*mi7.args())),
                  march_bound(torch, mi7)),
        "resolve": (cuda_ms(
                        lambda: screen_warp_cuda.resolve_screen(*res_args7)),
                    cuda_ms(lambda: screen_warp_cuda.resolve_screen_plain(
                        *res_args7)),
                    resolve_bound(res_args7)),
    }
    gs7 = grid_sample_call(torch, res_args7)
    grid_sample7_ms = cuda_ms(gs7)
    dev_us7 = {
        "march": device_us(lambda: march_cuda.march(
            *mi7.args(), ring=mi7.ring)),
        "resolve": device_us(
            lambda: screen_warp_cuda.resolve_screen(*res_args7)),
        "grid_sample": device_us(gs7),
    }
    hi_ms = {"static": cuda_ms(frame7_kernels)}
    pipe7.sync()
    hi_ms["deform"] = cuda_ms(frame7_deform)
    pipe7d.sync()
    hi_ms["static plain"] = cuda_ms(frame7_plain)
    hi_prof = {}
    for name, fn, p in (("static", frame7_kernels, pipe7),
                        ("deform", frame7_deform, pipe7d)):
        torch.cuda.reset_peak_memory_stats()
        prof = profile_frames(fn, p.sync, kernels)
        hi_prof[name] = (*prof, torch.cuda.max_memory_allocated() / 2**20)
    print(f"phase 11 work-queue kernel {GRID_HI}^3 {ms['parity_queue'][0]:.4f} "
          f"ms (plain {ms['parity_queue'][1]:.4f} ms), 512^3 {q512_ms[0]:.4f} "
          f"ms (plain {q512_ms[1]:.4f} ms; queue {sv512.stats}); binned "
          f"kernel on the same {GRID_HI}^3 mesh {binned256_ms:.4f} ms "
          f"(capacity {stats_b7.capacity}); DeformingVoxelizer.__call__ "
          f"{GRID_HI}^3 (re-bin + kernel) {deform_call_ms:.4f} ms (CUDA events "
          f"over {INNER} back-to-back runs, median of {REPS}); {card}")
    print(f"phase 11 at the {GRID_HI}^3 frame's inputs (m={m7}, "
          f"{mi7.slabs.shape[1] * mi7.ss} sub-slabs, ring (chunk slabs, rows, columns) "
          f"{mi7.ring}): march {render7['march'][0]:.4f} ms, "
          f"{dev_us7['march']:.2f} us device per call (plain "
          f"{render7['march'][1]:.4f} ms, bound {render7['march'][2]}), "
          f"resolve {render7['resolve'][0]:.4f} ms, {dev_us7['resolve']:.2f} "
          f"us device per call (plain {render7['resolve'][1]:.4f} ms, bound "
          f"{render7['resolve'][2]}, {resolve_hits(res_args7)} hit pixels), "
          f"grid_sample {grid_sample7_ms:.4f} ms, "
          f"{dev_us7['grid_sample']:.2f} us device per call; {card}")
    print("phase 11 work-queue kernel device us per call (profiler): "
          + ", ".join(f"{n_}^3 {q_dev_us[n_]:.2f}" for n_ in q_dev_us)
          + "; (column, row) pairs tested (parent kernel: every column of each "
          "live row) against needed (column centres in the bounding boxes): "
          + ", ".join(f"{n_}^3 {q_pairs[n_][0]} (parent {q_pairs[n_][1]}) / "
                      f"{q_needed[n_]}" for n_ in q_pairs) + f"; {card}")
    # ---- 11b. the work-queue kernel's sweep ---------------------------------
    q_sweep = {}
    for n_, v_ in ((GRID_HI, sv), (512, sv512)):
        fns = {variant: (lambda v_=v_, variant=variant:
                         vqc.voxelize_parity_queue_chunks(
                             v_.coefs, v_.chunk_tile, v_.chunk_nsub, v_.n,
                             spans=v_.spans, variant=variant))
               for variant in cases.QUEUE_VARIANTS}
        # the main layout without spans: every row against its whole tile;
        # and with spans empty in every tile (n, -1, n, -1): each row loaded
        # and its columns picked, no pair tested (a timing probe only)
        fns["main, no spans"] = lambda v_=v_: vqc.voxelize_parity_queue_chunks(
            v_.coefs, v_.chunk_tile, v_.chunk_nsub, v_.n)
        empty = torch.tensor([n_, -1, n_, -1], dtype=torch.int16, device=dev)
        empty = empty.expand(v_.spans.shape[0], 4).contiguous()
        fns["main, empty spans"] = (
            lambda v_=v_, e_=empty: vqc.voxelize_parity_queue_chunks(
                v_.coefs, v_.chunk_tile, v_.chunk_nsub, v_.n, spans=e_))
        q_sweep[n_] = time_sweep(torch, fns)
    q_cold_us = {n_: cold_device_us(torch, v_, flush)
                 for n_, v_ in ((GRID_HI, sv), (512, sv512))}
    print("phase 11b work-queue kernel sweep ((one block per tile run, "
          "threads): CUDA-event ms, profiler device us per call): "
          + "; ".join(f"{n_}^3 " + ", ".join(
              f"{v} {t[0]:.4f} ms {t[1]:.2f} us" for v, t in q_sweep[n_].items())
              for n_ in q_sweep) + "; the main layout with the L2 flushed "
          "before each call: " + ", ".join(f"{n_}^3 {us:.2f} us"
                                           for n_, us in q_cold_us.items())
          + f"; {card}")
    for name in ("static", "deform"):
        busy, per_frame, kus, peak = hi_prof[name]
        print(f"phase 11 frame {GRID_HI}^3 1280x720 -hq {name}: "
              f"{hi_ms[name]:.4f} ms with the kernels"
              + (f", {hi_ms['static plain']:.4f} ms plain"
                 if name == "static" else "")
              + f"; profiled: device busy {busy:.4f} ms per frame (idle share "
              f"{1 - busy / hi_ms[name]:.3f}), {per_frame:.0f} device kernels "
              f"and copies per frame, kernel device us per frame {kus}, peak "
              f"device memory {peak:.1f} MiB; {card}")

    # ---- 14. the ray-stab kernels against their plain versions ----------
    thr = rsf.INSIDE_THRESHOLD
    rs_lines = []

    def stab_case(name, verts, nrm, tris):
        accel = rsf.build_raystab_accel2(verts, tris, nrm, n=GRID)
        tc = int(tris.shape[0])
        streams = [(s_, tb) for s_, tb in (("main", accel.main),
                                           ("near-origin", accel.ov))
                   if tb is not None]
        check(bool(streams), f"{name}: empty accel")
        for s_, tb in streams:
            for rule in ("backface", "hit"):
                got = rsc.fold_extract(tb, tc, thr, rule)
                want = rsc.fold_extract_plain(tb, tc, thr, rule)
                for what, a, b in zip(("t", "id", "ns"), got, want):
                    check(torch.equal(a, b), f"fold_extract {what} differs "
                          f"from the plain version: {name} {s_} {rule}")
            for what, a, b in zip(("t", "id"), rsc.fold(tb), want[:2]):
                check(torch.equal(a, b), f"fold-only {what} differs from the "
                      f"plain fold: {name} {s_}")
        for rule in ("backface", "hit"):
            q_k = rsf.raystab_query2(accel, rule=rule)
            q_p = rsf.raystab_query2(accel, rule=rule, use_kernels=False)
            check(torch.equal(q_k[0], q_p[0]) and torch.equal(q_k[1], q_p[1]),
                  f"{name}: query {rule} differs from the plain query")
        check(bool(q_k[0].any()), f"{name}: empty grid")
        return accel, (f"{name} {tc} tris: " + ", ".join(
            f"{s_} {tb.strips} strips {tb.rows.shape[0]} rows"
            for s_, tb in streams))

    def dev_mesh3(verts, nrm, tris):
        v_, t_ = dev_mesh(verts, tris)
        return v_, torch.from_numpy(np.asarray(nrm, np.float32)).to(dev), t_

    rs_lines.append(stab_case("icosphere6", mb.positions_norm, mb.normals,
                              mb.tris)[1])
    rs_lines.append(stab_case("box_on_centers",
                              *dev_mesh3(*box_on_centers(GRID)))[1])
    rng = np.random.default_rng(11)
    tv = (rng.standard_normal((300, 1, 3)) * 0.02
          + rng.standard_normal((300, 3, 3)) * 0.3).astype(np.float32)
    fn_ = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    fn_ /= np.linalg.norm(fn_, axis=-1, keepdims=True)
    near = (tv.reshape(-1, 3), np.repeat(fn_, 3, axis=0).astype(np.float32),
            np.arange(900, dtype=np.int32).reshape(300, 3))
    accel_near, line = stab_case("near_origin", *dev_mesh3(*near))
    check(accel_near.ov is not None, "near-origin soup built no shared stream")
    rs_lines.append(line)
    # the whole query against the radial oracle (a mesh of ~5k triangles)
    v4_, n4_, t4_ = icosphere_mesh(4)
    v4d, n4d, t4d = dev_mesh3(v4_, n4_, t4_)
    accel4 = rsf.build_raystab_accel2(v4d, t4d, n4d, n=GRID)
    for rule in ("backface", "hit"):
        q = rsf.raystab_query2(accel4, rule=rule)
        r = voxelize_raystab_radial_ref(v4d, n4d, t4d, n=GRID, rule=rule)
        check(torch.equal(q[0], r[0]) and torch.equal(q[1], r[1]),
              f"query differs from the radial oracle at {GRID}^3 ({rule})")
    errs["raystab_fold_extract"] = errs["raystab_fold"] = 0.0

    # the ray-stab and -normals frames (phase 3b's first frames) against the
    # plain path
    accel_rs = pipe_rs._stab_accel

    def frame_rs_plain():
        occ, rgba = rsf.raystab_query2(accel_rs, use_kernels=False)
        grid = VoxelGrid(words=pack_bits_z(occ), rgba=quantize_r10g10b10a2(rgba))
        return render(grid, consts, cfg_rs, use_kernels=False)

    def frame_nm_plain():
        words = voxelize_cuda.voxelize_parity_tiles_plain(coef_main, GRID)
        _, rgba = rsf.raystab_query2(pipe_nm._stab_accel, rule="hit",
                                     use_kernels=False)
        occ_f = unpack_bits_z(words, GRID).to(torch.float32)[..., None]
        rgba = quantize_r10g10b10a2(torch.cat([rgba[..., :3] * occ_f, occ_f], -1))
        return render(VoxelGrid(words=words, rgba=rgba), consts, cfg_nm,
                      use_kernels=False)

    stab_frame_err = {}
    for name, f_k, plain in (("raystab", f_rs, frame_rs_plain),
                             ("normals", f_nm, frame_nm_plain)):
        check(bool(torch.isfinite(f_k).all()) and f_k.shape == (720, 1280, 3),
              f"{name} frame not finite or misshapen")
        stab_frame_err[name] = max_err(f_k, plain())
        check(stab_frame_err[name] <= TOL_FRAME,
              f"{name} frame differs by {stab_frame_err[name]:.3g}")
    print("phase 14 ray-stab kernels bit-identical to their plain versions on "
          "(t, id, ns), rules backface and hit, fold-only on (t, id) ("
          + "; ".join(rs_lines) + f"); query bit-identical to the radial "
          f"oracle at {GRID}^3 on a {len(t4_)}-triangle icosphere, both rules; "
          f"frames max|err| kernels vs plain: raystab "
          f"{stab_frame_err['raystab']:.3g}, -normals "
          f"{stab_frame_err['normals']:.3g}")

    # ---- 14b. the fold kernel's synthetic stress strips -------------------
    sc = cases.stab_stress(dev)
    many = sc.strips["many_chunks"][0]
    runs = cases.chunks_run(sc.tables, many)
    check(len(runs) == sc.many_chunks > 8 and runs[0] and not all(runs),
          f"the many-chunk strip runs chunks {runs}")
    for rule in ("backface", "hit"):
        want = rsc.fold_extract_plain(sc.tables, sc.t_count, thr, rule)
        ties = sc.strips["ties"]
        low = sc.lowest[ties]
        check(torch.equal(torch.where(low >= 0, want[1][ties], -1), low),
              "stress: the plain fold did not pick the lowest id")
        for variant in [None, *cases.FOLD_VARIANTS]:
            got = rsc.fold_extract(sc.tables, sc.t_count, thr, rule,
                                   variant=variant)
            for what, a_, b_ in zip(("t", "id", "ns"), got, want):
                check(torch.equal(a_, b_), f"stress: fold_extract {what} "
                      f"differs from the plain version ({variant}, {rule})")
    for what, a_, b_ in zip(("t", "id"), rsc.fold(sc.tables),
                            rsc.fold_plain(sc.tables)):
        check(torch.equal(a_, b_), f"stress: fold-only {what} differs")
    print(f"phase 14b fold + extraction at the main path's settings and every "
          f"setting of the sweep {cases.FOLD_VARIANTS} (groups, stages, deferred "
          f"division), and the fold alone, bit-identical to the plain "
          f"versions on (t, id, ns), both rules, on synthetic strips: "
          f"{len(sc.strips['ties'])} equal-t strips, lowest id winning on "
          f"{int((sc.lowest >= 0).sum())} lanes across chunk and sub-chunk "
          f"boundaries; a {sc.tables.cand_cnt[many].item()}-row strip of "
          f"{sc.many_chunks} chunks, run/skipped {runs}; "
          f"{len(sc.strips['padding'])} all-padding strips")

    # ---- 15. ray-stab timings ---------------------------------------------
    tb_rs = accel_rs.main
    tc6 = int(mb.tris.shape[0])
    ms["raystab_fold_extract"] = (
        cuda_ms(lambda: rsc.fold_extract(tb_rs, tc6, thr)),
        cuda_ms(lambda: rsc.fold_extract_plain(tb_rs, tc6, thr)),
    )
    ms["raystab_fold"] = (
        cuda_ms(lambda: rsc.fold(tb_rs)),
        cuda_ms(lambda: rsc.fold_plain(tb_rs)),
    )
    # the accel build: the first from a cold ray table, then 3 warm ones
    rsf._ray_table_filled.cache_clear()
    builds = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        compact = rsf.build_raystab_compact2(mb.positions_norm, mb.tris, GRID)
        t1 = time.perf_counter()
        rsf.assemble_raystab_accel2(compact, mb.positions_norm, mb.tris,
                                    mb.normals)
        torch.cuda.synchronize()
        builds.append((t1 - t0, time.perf_counter() - t1))
    host_s, asm_s = (statistics.median(b[i] for b in builds[1:]) for i in (0, 1))
    # the three 64^3 frames in turns again, late in the run (phase 3b timed
    # them first): how far host time drifted
    turns = frames_in_turns(torch, frames64)
    stab_ms = {k: statistics.median(v) for k, v in early.items()}
    stab_ms["raystab plain"] = cuda_ms(frame_rs_plain)
    stab_ms["normals plain"] = cuda_ms(frame_nm_plain)
    stab_prof = {}
    for name, fn, p in (("raystab", frame_rs, pipe_rs),
                        ("normals", frame_nm, pipe_nm)):
        torch.cuda.reset_peak_memory_stats()
        prof = profile_frames(fn, p.sync, kernels)
        stab_prof[name] = (*prof, torch.cuda.max_memory_allocated() / 2**20)
    work_rs = raystab_work(torch, rsc, tb_rs)
    pass_rs = raystab_pass_pairs(torch, rsc, tb_rs)
    rs_dev_us = {
        "raystab_fold_extract": device_us(
            lambda: rsc.fold_extract(tb_rs, tc6, thr)),
        "raystab_fold": device_us(lambda: rsc.fold(tb_rs)),
    }
    # ---- 15b. the fold + extraction kernel's sweep --------------------------
    rs_sweep = time_sweep(torch, {
        variant: (lambda variant=variant: rsc.fold_extract(
            tb_rs, tc6, thr, variant=variant))
        for variant in cases.FOLD_VARIANTS})
    rs_cold_us = {v: cold_device_us(torch, lambda v=v: rsc.fold_extract(
        tb_rs, tc6, thr, variant=v), flush)
        for v in (None, (1, 1, True), (1, 2, True), (1, 3, True), (2, 3, True))}
    rs_cold_us["fold-only"] = cold_device_us(torch, lambda: rsc.fold(tb_rs),
                                             flush)
    print(f"phase 15 ray-stab kernels at the {GRID}^3 frame's tables "
          f"({tb_rs.strips} strips, {tb_rs.rows.shape[0]} candidate rows, "
          f"{work_rs[0]} real rays; in the chunks not skipped "
          f"{work_rs[1]} candidate rows and {work_rs[2]} real pairs; classes "
          f"{[c[1].shape for c in compact.classes]}): fold+extract "
          f"{ms['raystab_fold_extract'][0]:.4f} ms (plain "
          f"{ms['raystab_fold_extract'][1]:.4f} ms), fold-only "
          f"{ms['raystab_fold'][0]:.4f} ms (plain {ms['raystab_fold'][1]:.4f} "
          f"ms); accel build from a cold ray table: host {builds[0][0]:.4f} s, "
          f"device assembly {builds[0][1]:.4f} s; warm (median of 3): host "
          f"{host_s:.4f} s, device assembly {asm_s:.4f} s; {card}")
    print(f"phase 15 fold + extraction {rs_dev_us['raystab_fold_extract']:.2f} "
          f"us device per call, fold-only {rs_dev_us['raystab_fold']:.2f} us "
          f"(profiler); of {pass_rs[0]} real (ray, candidate) pairs, "
          f"{pass_rs[1]} pass the sign test and |den| > eps (the divisions); of "
          f"{pass_rs[2]} (warp, candidate) steps, {pass_rs[3]} hold such a "
          f"pair; {card}")
    print("phase 15b fold + extraction sweep at the 64^3 frame's tables "
          "((groups, stages, deferred division): CUDA-event ms, profiler "
          "device us per call): " + ", ".join(
              f"{v} {t[0]:.4f} ms {t[1]:.2f} us" for v, t in rs_sweep.items())
          + "; with the L2 flushed before each call (device us): " + ", ".join(
              f"{'main' if v is None else v} {us:.2f}"
              for v, us in rs_cold_us.items()) + f"; {card}")
    print(f"phase 15 frames {GRID}^3 1280x720 -hq timed in turns late in the "
          f"run (parity, raystab, normals, normals, raystab, parity; each a "
          f"median of {REPS} runs of {INNER}): "
          + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.4f} ms" for k, v in turns.items())
          + f"; {card}")
    for name in ("raystab", "normals"):
        busy, per_frame, kus, peak = stab_prof[name]
        print(f"phase 15 frame {GRID}^3 1280x720 -hq {name}: "
              f"{stab_ms[name]:.4f} ms with the kernels (median of phase "
              f"3b's turns), "
              f"{stab_ms[name + ' plain']:.4f} ms plain; profiled: device "
              f"busy {busy:.4f} ms per frame (idle share "
              f"{1 - busy / stab_ms[name]:.3f}), {per_frame:.0f} device "
              f"kernels and copies per frame, kernel device us per frame "
              f"{kus}, peak device memory {peak:.1f} MiB; {card}")

    # ---- 16. the core-tier gen-1 path and kernel 2.8 ------------------------
    # build_raystab_accel's two halves: host binning + voxel->cell ray table,
    # then the device slice stream; the first from a cold ray table, then 3
    # warm ones
    rsf.ray_tables.cache_clear()
    rsf._ray_table_filled.cache_clear()
    builds1 = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cand_ids, cand_off, ov_ids, stats1 = rsf.bin_triangles_radial(
            mb.positions_norm, mb.tris)
        ray_ids, ray_off = rsf.ray_tables(GRID, 32)
        t1 = time.perf_counter()
        acc1 = rsf.assemble_raystab_accel(
            mb.positions_norm, mb.tris, GRID, 32,
            (ray_ids, ray_off, cand_ids, cand_off), ov_ids, stats1)
        torch.cuda.synchronize()
        builds1.append((t1 - t0, time.perf_counter() - t1))
    host1_s, asm1_s = (statistics.median(b[i] for b in builds1[1:]) for i in (0, 1))
    per_query = 1 + (acc1.ov is not None)

    def gen1_frame(consts_):
        grid = voxelize(mb, GRID, mode="raystab", accel=acc1)
        return render(grid, consts_, cfg_rs)

    # 4 orbiting frames, every launch count set to 0 just before
    cam1 = OrbitCamera(cfg.width, cfg.height)
    for k in kernels:
        k.launches = 0
    for f in range(FRAMES):
        if f:
            cam1.orbit(12.0, 0.0)
        img1 = gen1_frame(scene.update_frame(cam1.eye, cam1.view_proj,
                                             cfg.width, cfg.height))
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    check(launches["raystab_mt"] == FRAMES * per_query,
          f"gen-1: raystab_mt launched {launches['raystab_mt']} times in "
          f"{FRAMES} queries")
    for k in ("parity_voxelize", "parity_queue", "raystab_fold_extract"):
        check(launches[k] == 0, f"gen-1: {k} ran: {launches}")
    for k in path_kernels["gen1"]:
        check(launches[k] >= FRAMES, f"gen-1: {k} launched {launches[k]} "
              f"times in {FRAMES} frames")
    once_per_frame(launches, "gen-1 frames")
    for k, c in launches.items():
        main_launches[k] += c
    check(bool(torch.isfinite(img1).all()) and img1.shape == (720, 1280, 3),
          "gen-1 frame not finite or misshapen")
    clear = torch.tensor(cfg.clear_color, dtype=torch.float32, device=dev)
    covered1 = float(((img1 - clear).abs().sum(-1) > 3 / 255).float().mean())
    check(0.05 < covered1 < 0.9, f"gen-1: volume covers {covered1:.3f}")

    # kernel 2.8 against its plain version, bit for bit on (t, id)
    mt_lines = []

    def mt_stream_case(name, tb):
        """Kernel 2.8 on one slice stream against its plain version on
        (t, id): the main path's settings and every setting of the sweep."""
        want = rmt.closest_hit_plain(tb)
        for variant in [None, *cases.MT_VARIANTS]:
            got = rmt.closest_hit(tb, variant=variant)
            for what, a, b in zip(("t", "id"), got, want):
                check(torch.equal(a, b), f"raystab_mt {what} ({variant}) "
                      f"differs from the plain version: {name}")
        mt_lines.append(f"{name} {tb.slices} slices of {tb.lanes} lanes "
                        f"{tb.rows.shape[0]} rows "
                        f"{int(torch.isfinite(want[0]).sum())} hits")
        return want

    def mt_case(name, accel):
        for s_, tb in (("cells", accel.main), ("overflow", accel.ov)):
            if tb is not None:
                mt_stream_case(f"{name} {s_}", tb)

    mt_case("icosphere6", acc1)
    vb_, nb_, tb_ = dev_mesh3(*box_on_centers(GRID))
    mt_case("box_on_centers", rsf.build_raystab_accel(vb_, tb_, n=GRID))
    vn_, nn_, tn_ = dev_mesh3(*near)
    acc_near = rsf.build_raystab_accel(vn_, tn_, n=GRID)
    check(acc_near.ov is not None and acc_near.ov.rows.shape[0] == 300,
          "near-origin soup: expected 300 overflow rows")
    mt_case("near_origin", acc_near)
    for lanes in rmt.SLICE_LANES:  # the stress stream at every slice width
        mt_stream_case("stress", cases.mt_stress(dev, lanes))
    # the query against the Moller-Trumbore oracle and the plain query
    acc4 = rsf.build_raystab_accel(v4d, t4d, n=GRID)
    q = rsf.raystab_query(v4d, n4d, t4d, acc4)
    r = voxelize_raystab_ref(v4d, n4d, t4d, n=GRID)
    check(torch.equal(q[0], r[0]) and torch.equal(q[1], r[1]),
          f"gen-1 query differs from the Moller-Trumbore oracle at {GRID}^3")
    q1 = rsf.raystab_query(mb.positions_norm, mb.normals, mb.tris, acc1)
    q1p = rsf.raystab_query(mb.positions_norm, mb.normals, mb.tris, acc1,
                            use_kernels=False)
    check(torch.equal(q1[0], q1p[0]) and torch.equal(q1[1], q1p[1]),
          "gen-1 query differs from the plain query on the icosphere")
    # against the gen-6 (radial) grid of the same mesh: the two inside rules
    # differ only at floating-point near-ties
    occ6, _ = rsf.raystab_query2(accel_rs)
    rule_diff = int((q1[0] != occ6).sum())
    check(rule_diff <= 0.01 * int(occ6.sum()),
          f"gen-1 and gen-6 grids differ in {rule_diff} voxels")
    errs["raystab_mt"] = 0.0

    def gen1_frame_plain():
        occ, rgba = rsf.raystab_query(mb.positions_norm, mb.normals, mb.tris,
                                      acc1, use_kernels=False)
        grid = VoxelGrid(words=pack_bits_z(occ), rgba=quantize_r10g10b10a2(rgba))
        return render(grid, consts, cfg_rs, use_kernels=False)

    gen1_err = max_err(gen1_frame(consts), gen1_frame_plain())
    check(gen1_err <= TOL_FRAME, f"gen-1 frame differs by {gen1_err:.3g}")

    ms["raystab_mt"] = (cuda_ms(lambda: rmt.closest_hit(acc1.main)),
                        cuda_ms(lambda: rmt.closest_hit_plain(acc1.main)))
    mt_dev_us = device_us(lambda: rmt.closest_hit(acc1.main))
    mt_host_us = host_us(torch, lambda: rmt.closest_hit(acc1.main))
    # ---- 16b. kernel 2.8's sweep: slice widths x settings -------------------
    want1 = rmt.closest_hit_plain(acc1.main)
    mt_sweep, mt_cold_us, mt_slots = {}, {}, {}
    for lanes in rmt.SLICE_LANES:
        acc_l = rsf.assemble_raystab_accel(
            mb.positions_norm, mb.tris, GRID, 32,
            (ray_ids, ray_off, cand_ids, cand_off), ov_ids, stats1, lanes=lanes)
        tb_l = acc_l.main
        fns = {}
        for variant in cases.MT_VARIANTS:
            got = rmt.closest_hit(tb_l, variant=variant)
            for what, a, b in zip(("t", "id"), got, want1):
                check(torch.equal(a, b), f"raystab_mt {what} ({lanes} lanes, "
                      f"{variant}) differs from the plain version")
            fns[(lanes, *variant)] = lambda tb_l=tb_l, variant=variant: (
                rmt.closest_hit(tb_l, variant=variant))
        mt_sweep.update(time_sweep(torch, fns))
        mt_cold_us[lanes] = cold_device_us(
            torch, lambda tb_l=tb_l: rmt.closest_hit(tb_l), flush)
        cnt, cc = tb_l.ray_cnt.long(), tb_l.cand_cnt.long()
        mt_slots[lanes] = (tb_l.slices, int((cc * lanes).sum()),
                           int(((cnt + 31) // 32 * 32 * cc).sum()),
                           int((cnt * cc).sum()))
    gen1_ms = cuda_ms(lambda: gen1_frame(consts))
    torch.cuda.reset_peak_memory_stats()
    busy1, per_frame1, kus1 = profile_frames(
        lambda: gen1_frame(consts), torch.cuda.synchronize, kernels)
    peak1 = torch.cuda.max_memory_allocated() / 2**20
    # the work the function needs: each cell's candidate rows once (40 of
    # their 48 bytes), each ray's origin and direction in and (t, id) out,
    # the real (ray, candidate) pairs of the slices (and every ray against
    # every overflow row), each counted up to the test where it leaves
    main1 = acc1.main
    streams1 = [tb for tb in (main1, acc1.ov) if tb is not None]
    stages1 = [sum(c) for c in zip(*(mt_stage_pairs(torch, tb) for tb in streams1))]
    pairs1 = stages1[0]
    ops1 = sum(c * k for c, k in zip(stages1, MT_OPS_BY_STAGE))
    rows1 = sum(tb.rows.shape[0] for tb in streams1)
    v1 = GRID ** 3
    bytes1 = rows1 * 40 + v1 * (24 + 8)
    cell_rays = np.diff(ray_off)
    print(f"phase 16 gen-1 accel on the {len(t6)}-triangle icosphere at "
          f"{GRID}^3: {stats1}, {main1.slices} slices, {main1.rows.shape[0]} "
          f"candidate rows, at most {int(cell_rays.max())} rays per direction "
          f"cell, {pairs1} real (ray, candidate) pairs, of which "
          f"{stages1[1:]} pass |det| > eps, u >= 0, v >= 0, u + v <= 1 and "
          f"hit: {ops1} operations ({ops1 / max(1, pairs1):.2f} per pair; "
          f"{ops1 / PEAK_FP32 * 1e3:.6f} ms at {PEAK_FP32 / 1e12:g} TFLOP/s, "
          f"which counts an FMA as 2, {2 * ops1 / PEAK_FP32 * 1e3:.6f} ms at "
          f"the unfused rate of its _rn chains), {bytes1} bytes "
          f"({bytes1 / PEAK_BYTES * 1e3:.6f} ms); build from a cold ray "
          f"table: host {builds1[0][0]:.4f} s, device {builds1[0][1]:.4f} s; "
          f"warm (median of 3): host {host1_s:.4f} s, device {asm1_s:.4f} s; "
          f"{card}")
    print(f"phase 16 core-tier frames (voxelize mode=raystab accel=gen-1 + "
          f"render, {GRID}^3 1280x720 -hq, {FRAMES} orbiting): launches "
          f"{launches}, volume covers {covered1:.3f} of the image; kernel "
          f"bit-identical to its plain version on (t, id) ("
          + "; ".join(mt_lines) + f"); query bit-identical to the "
          f"Moller-Trumbore oracle at {GRID}^3 on a {len(t4_)}-triangle "
          f"icosphere and to the plain query; gen-1 vs gen-6 grid "
          f"{rule_diff} of {int(occ6.sum())} voxels differ; frame max|err| "
          f"kernels vs plain {gen1_err:.3g}")
    print(f"phase 16b Moller-Trumbore kernel sweep at the {GRID}^3 gen-1 "
          f"accel ((lanes per slice, threads per block, deferred division, "
          f"staged rows): CUDA-event ms, profiler device us per call; every "
          f"setting bit-identical to the plain version): " + ", ".join(
              f"{v} {t[0]:.4f} ms {t[1]:.2f} us" for v, t in mt_sweep.items())
          + "; main settings with the L2 flushed before each call (device "
          "us): " + ", ".join(f"{k} lanes {us:.2f}" for k, us in mt_cold_us.items())
          + "; (slices, (lane, candidate) slots, those of the warps holding "
          "a ray, real pairs): "
          + ", ".join(f"{k} lanes {v}" for k, v in mt_slots.items())
          + f"; main path {rmt.LANES} lanes; {card}")
    print(f"phase 16 kernel {ms['raystab_mt'][0]:.4f} ms, {mt_dev_us:.2f} us "
          f"device per call, wrapper host {mt_host_us:.2f} us per call (plain "
          f"{ms['raystab_mt'][1]:.4f} ms); core-tier frame {gen1_ms:.4f} ms "
          f"(CUDA events over {INNER} back-to-back runs, median of {REPS}); "
          f"profiled: device busy {busy1:.4f} ms per frame (idle share "
          f"{1 - busy1 / gen1_ms:.3f}), {per_frame1:.0f} device kernels and "
          f"copies per frame, kernel device us per frame {kus1}, peak device "
          f"memory {peak1:.1f} MiB; {card}")

    # ---- 18. gen-7 (n >= 128): its build, the query against its plain
    # version, the radial oracle and gen-6; the refitters -------------------
    rst, rrf = raystab_tiled, raystab_refit
    tc7 = int(mb7.tris.shape[0])
    rules = ("backface", "hit")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def stream_bytes(tb):
        return sum(x.numel() * x.element_size() for x in
                   (tb.rays, tb.cand_off, tb.cand_cnt, tb.rows,
                    *(x_ for x_ in (tb.bounds, tb.row_ids) if x_ is not None)))

    def stab_query(acc, rule="backface"):
        q_ = (rst.raystab_query7 if isinstance(acc, rst.RaystabAccel7)
              else rsf.raystab_query2)
        return q_(acc, rule=rule)

    def same_query(a, b, what):
        for rule in rules:
            qa, qb = stab_query(a, rule), stab_query(b, rule)
            check(torch.equal(qa[0], qb[0]) and torch.equal(qa[1], qb[1]),
                  f"{what} ({rule}) differ")

    # the build at 256^3 by stage: the grid's voxel->cell pairs and tile
    # radii alone; the compact (host binning + device tile union) and its
    # assembly, cold (the grid's tables computed first) and warm (cached,
    # median of 3); through the on-disk cache: the miss (build + save), then
    # loads (median of 3)
    g7 = rsf.default_gs(GRID_HI)[0]
    rst._tile_statics.cache_clear()
    _, statics_s = timed(lambda: rst._tile_statics(GRID_HI, g7, str(dev)))
    rst._tile_statics.cache_clear()
    b7 = []
    for _ in range(4):
        compact7, c_s = timed(lambda: rst.build_raystab_compact7(
            mb7.positions_norm, mb7.tris, GRID_HI))
        accel7, a_s = timed(lambda: rst.assemble_raystab_accel7(
            compact7, mb7.positions_norm, mb7.tris, mb7.normals))
        b7.append((c_s, a_s))
    warm7 = tuple(statistics.median(b[i] for b in b7[1:]) for i in (0, 1))
    cdir = os.path.join(accel_cache_dir, "phase18")
    _, miss7_s = timed(lambda: accel_cache.cached_compact7(
        mb7.positions_norm, mb7.tris, GRID_HI, cache_dir=cdir))
    loads7 = []
    for _ in range(3):
        c_l, l_s = timed(lambda: accel_cache.cached_compact7(
            mb7.positions_norm, mb7.tris, GRID_HI, cache_dir=cdir))
        a_l, al_s = timed(lambda: rst.assemble_raystab_accel7(
            c_l, mb7.positions_norm, mb7.tris, mb7.normals))
        loads7.append((l_s, al_s))
    check(all(torch.equal(getattr(c_l, k), getattr(compact7, k))
              for k in ("tids", "offs", "ids"))
          and (c_l.bounds is None) == (compact7.bounds is None)
          and (c_l.bounds is None or torch.equal(c_l.bounds, compact7.bounds)),
          "the cached gen-7 compact differs from the built one")
    load7 = tuple(statistics.median(b[i] for b in loads7) for i in (0, 1))
    cache7_mb = sum(f.stat().st_size for f in Path(cdir).iterdir()) / 2**20
    del c_l, a_l
    tb7 = accel7.main
    bytes7 = stream_bytes(tb7) + accel7.tids.numel() * 8
    cnt7 = tb7.cand_cnt.long()

    # the kernel against its plain version at 256^3, bit for bit
    for rule in rules:
        got = rsc.fold_extract(tb7, tc7, thr, rule)
        want = rsc.fold_extract_plain(tb7, tc7, thr, rule)
        for what, a_, b_ in zip(("t", "id", "ns"), got, want):
            check(torch.equal(a_, b_), f"gen-7 {GRID_HI}^3: fold_extract "
                  f"{what} differs from the plain version ({rule})")
    del got, want
    # the stateless core-tier call routes to gen-7 and equals the accel's
    for k in kernels:
        k.launches = 0
    g_sl = voxelize(mb7, GRID_HI, mode="raystab", quantize=False)
    check(rsc.FOLD_EXTRACT.launches == 1, "voxelize(mode=raystab, n=256) "
          f"launched the fold {rsc.FOLD_EXTRACT.launches} times")
    q7 = rst.raystab_query7(accel7)
    check(torch.equal(g_sl.occupancy(), q7[0]) and torch.equal(g_sl.rgba, q7[1]),
          f"voxelize(mode=raystab, n={GRID_HI}) differs from the gen-7 query")
    occ7_count = int(q7[0].sum())
    del g_sl, q7
    # gen-6 against gen-7 on the same mesh at 128^3 and 256^3: equal grids
    compact6, c6_s = timed(lambda: rsf.build_raystab_compact2(
        mb7.positions_norm, mb7.tris, GRID_HI))
    accel6, a6_s = timed(lambda: rsf.assemble_raystab_accel2(
        compact6, mb7.positions_norm, mb7.tris, mb7.normals))
    same_query(accel6, accel7, f"gen-6 and gen-7 grids at {GRID_HI}^3")
    accel7_128, c7_128_s = timed(lambda: rst.build_raystab_accel7(
        mb7.positions_norm, mb7.tris, mb7.normals, n=128))
    accel6_128, c6_128_s = timed(lambda: rsf.build_raystab_accel2(
        mb7.positions_norm, mb7.tris, mb7.normals, n=128))
    same_query(accel6_128, accel7_128, "gen-6 and gen-7 grids at 128^3")
    # the radial oracle at 128^3: a 5,120-triangle icosphere and the box
    # with faces on voxel centres
    oracle7 = []
    for name, (v_, n_, t_) in (("icosphere4", (v4d, n4d, t4d)),
                               ("box_on_centers", dev_mesh3(*box_on_centers(128)))):
        a_ = rst.build_raystab_accel7(v_, t_, n_, n=128)
        for rule in rules:
            q_ = rst.raystab_query7(a_, rule=rule)
            r_ = voxelize_raystab_radial_ref(v_, n_, t_, n=128, rule=rule)
            check(torch.equal(q_[0], r_[0]) and torch.equal(q_[1], r_[1]),
                  f"gen-7 differs from the radial oracle at 128^3: {name} {rule}")
        oracle7.append(f"{name} {int(t_.shape[0])} tris {a_.stats.live_tiles} "
                       f"live tiles {int(q_[0].sum())} voxels hit")
    # the refitters against fresh builds of two wobbled frames (the app's
    # -deform); the first refit checks the contract
    rf7, rf7_s = timed(lambda: rst.RaystabTiledRefitter(
        mb7.positions_norm, mb7.tris, mb7.normals, GRID_HI,
        pad=cfg_hi.deform_pad, pad_dirs=mb7.normals))
    rf6, rf6_s = timed(lambda: rrf.RaystabRefitter(
        mb7.positions_norm, mb7.tris, mb7.normals, GRID,
        pad=cfg_hi.deform_pad, pad_dirs=mb7.normals))
    for name, rf_, n_, fresh in (
            ("gen-7", rf7, GRID_HI, rst.build_raystab_accel7),
            ("gen-6", rf6, GRID, rsf.build_raystab_accel2)):
        for f in (1, 7):
            wm = wobbled(mb7, base_x, f)
            same_query(rf_.refit(wm.positions_norm, check=f == 1),
                       fresh(wm.positions_norm, mb7.tris, mb7.normals, n=n_),
                       f"{name} refit and fresh build at {n_}^3, frame {f}")
    wob7 = wobbled(mb7, base_x, 5).positions_norm
    refit_t = {name: time_sweep(torch, {"refit": lambda rf_=rf_: rf_.refit(wob7)})["refit"]
               for name, rf_ in (("gen-7", rf7), ("gen-6", rf6))}
    # refitted streams read their rows through ids: the kernels against
    # their plain versions on the rows they stand for (gen-7 at 256^3 on
    # this mesh and on the cells' torus; gen-6 at 64^3 on this mesh with
    # the near-origin soup: both streams); the fold on materialised rows
    # against row ids
    vno, nno, tno = dev_mesh3(*near)
    mb6o = dataclasses.replace(
        mb7, positions=torch.cat([mb7.positions, vno]),
        normals=torch.cat([mb7.normals, nno]),
        tris=torch.cat([mb7.tris, tno + mb7.positions.shape[0]]),
        positions_norm=torch.cat([mb7.positions_norm, vno]))
    torus_obj = Path(accel_cache_dir) / "torus.obj"
    tv_, tt_ = torus_mesh()
    write_obj(torus_obj, tv_ * WORLD_SCALE + WORLD_CENTER, tt_)
    mbt = Scene.load(cfg_hi.replace(mesh=str(torus_obj)), device=dev).buffers
    by_id = {}
    for name, mesh_, n_, cls in (
            (f"gen-7 {GRID_HI}^3 icosphere", mb7, GRID_HI, rst.RaystabTiledRefitter),
            (f"gen-7 {GRID_HI}^3 torus", mbt, GRID_HI, rst.RaystabTiledRefitter),
            (f"gen-6 {GRID}^3 icosphere + near-origin soup", mb6o, GRID,
             rrf.RaystabRefitter)):
        rf_ = rf7 if mesh_ is mb7 and n_ == GRID_HI else cls(
            mesh_.positions_norm, mesh_.tris, mesh_.normals, n_,
            pad=cfg_hi.deform_pad, pad_dirs=mesh_.normals)
        check(n_ == GRID_HI or set(rf_._ids) == {"main", "ov"},
              f"{name}: the refitter has streams {set(rf_._ids)}")
        wm = wobbled(mesh_, mesh_.positions_norm[:, :1].cpu().numpy(), 4)
        by_id[name] = by_id_case(torch, rsc, rf_, wm.positions_norm,
                                 int(mesh_.tris.shape[0]), thr, flush)
        del rf_, wm
    del mb6o, mbt
    # a deforming frame after its first: refit + query + packing under
    # set_sync_debug_mode("error"); and the host syncs of a whole frame
    # (render included) counted under "warn"
    sync_lines = []
    for n_ in (GRID_HI, GRID):
        p_ = FramePipeline(cfg_hi.replace(inside_mode="raystab", grid_size=n_),
                           mb7, deforming=True)
        p_.mesh = wobbled(mb7, base_x, 1)
        p_.frame(consts7)  # the first refit frame: the contract check
        p_.sync()
        wm = wobbled(mb7, base_x, 2)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            p_.mesh = wm
            g_ = voxelize(wm, n_, mode="raystab", accel=p_._raystab_accel())
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(bool(g_.words.any()), f"the deforming {n_}^3 frame is empty")
        sites = []  # the repository's innermost frame at each sync

        def record_sync(*args, **kwargs):
            sites.append(next((f"{Path(fs.filename).name}:{fs.lineno} "
                               f"{fs.name}" for fs in
                               reversed(traceback.extract_stack()[:-1])
                               if str(root) in fs.filename
                               and not fs.filename.endswith("chip_smoke.py")),
                              "outside the package"))

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record_sync
            torch.cuda.set_sync_debug_mode("warn")
            try:
                p_.mesh = wobbled(mb7, base_x, 3)
                p_.frame(consts7)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        p_.sync()
        sync_lines.append(f"{n_}^3 refit {type(p_._refitter).__name__}: "
                          f"{len(sites)} host syncs in a whole frame, at {sites}")
        del p_, g_
    # gen-6 against gen-7 timings (query: kernel + scatter; the fold alone)
    stab_cmp = {}
    for n_, a6, a7 in ((128, accel6_128, accel7_128), (GRID_HI, accel6, accel7)):
        stab_cmp[n_] = time_sweep(torch, {
            "gen-6 query": lambda a6=a6: rsf.raystab_query2(a6),
            "gen-7 query": lambda a7=a7: rst.raystab_query7(a7),
            "gen-6 fold": lambda a6=a6: rsc.fold_extract(a6.main, tc7, thr),
            "gen-7 fold": lambda a7=a7: rsc.fold_extract(a7.main, tc7, thr),
        })
        stab_cmp[n_]["shape"] = (
            f"gen-6 {a6.main.strips} strips {a6.main.rows.shape[0]} rows"
            f"{'' if a6.ov is None else f' + {a6.ov.rows.shape[0]} near-origin'}"
            f", gen-7 {a7.main.strips} live tiles {a7.main.rows.shape[0]} rows")
    fold7_cold_us = cold_device_us(
        torch, lambda: rsc.fold_extract(tb7, tc7, thr), flush)
    work7 = raystab_work(torch, rsc, tb7)
    work6 = raystab_work(torch, rsc, accel6.main)
    bound7 = raystab_bound(tb7, work7, True)
    fold7_ms = stab_cmp[GRID_HI]["gen-7 fold"]
    print(f"phase 18 gen-7 build at {GRID_HI}^3 on the {tc7}-triangle "
          f"icosphere ({compact7.stats}): the grid's cell pairs and tile radii "
          f"alone {statics_s:.4f} s; cold: compact {b7[0][0]:.4f} s, assembly "
          f"{b7[0][1]:.4f} s; warm (median of 3): compact {warm7[0]:.4f} s, "
          f"assembly {warm7[1]:.4f} s; the accel cache: miss (build + save) "
          f"{miss7_s:.4f} s, load {load7[0]:.4f} s + assembly {load7[1]:.4f} s "
          f"(median of 3), entry {cache7_mb:.1f} MiB; accel {bytes7 / 2**20:.1f} "
          f"MiB, at most {int(cnt7.max())} candidates per tile; gen-6 at "
          f"{GRID_HI}^3: compact {c6_s:.4f} s, assembly {a6_s:.4f} s, "
          f"{stream_bytes(accel6.main) / 2**20:.1f} MiB; at 128^3 gen-7 build "
          f"{c7_128_s:.4f} s, gen-6 {c6_128_s:.4f} s; {card}")
    print(f"phase 18 gen-7 at {GRID_HI}^3: fold + extraction bit-identical to "
          f"its plain version on (t, id, ns), both rules; voxelize(mode="
          f"raystab, n={GRID_HI}) routes to gen-7 (one fold launch) and equals "
          f"the accel's query ({occ7_count} voxels inside); gen-7 grids "
          f"bit-identical to gen-6 at 128^3 and {GRID_HI}^3, both rules; to "
          f"the radial oracle at 128^3 ({'; '.join(oracle7)}), both rules; "
          f"refitted accels (gen-7 at {GRID_HI}^3 built in {rf7_s:.4f} s, "
          f"{rf7.rest_accel.main.row_ids.numel()} candidate rows; gen-6 at "
          f"{GRID}^3 in {rf6_s:.4f} s, {rf6.rest_accel.main.row_ids.numel()} "
          f"candidate rows; pad "
          f"{cfg_hi.deform_pad} along the normals) bit-identical to fresh "
          f"builds of two wobbled frames; refit per frame (CUDA-event ms, "
          f"profiler device us): " + ", ".join(
              f"{k} {v[0]:.4f} ms {v[1]:.2f} us" for k, v in refit_t.items())
          + "; under set_sync_debug_mode('error') the refit + query ran "
          "without a host sync; " + "; ".join(sync_lines))
    print("phase 18 refitted streams read through their row ids (frame 4 of "
          "the wobble), the fold kernels bit-identical to their plain "
          "versions on the rows each stream stands for (both rules, the main "
          "path and the sweep's (2, 2, False), the fold alone): " + "; ".join(
              f"{name}: {rows_} candidate rows, {rows_ * 96} B the refit no "
              f"longer writes per frame ({rows_ * 96 / 2**20:.1f} MiB); fold + "
              "extraction on the main stream (CUDA-event us per call, warm / "
              "with the L2 flushed, forward pass then backward): " + ", ".join(
                  f"{k} " + " then ".join(f"{w:.2f} / {c:.2f}" for w, c in v)
                  for k, v in t_.items())
              for name, (rows_, t_) in by_id.items()) + f"; {card}")
    print("phase 18 gen-6 against gen-7 on the same mesh (CUDA-event ms, "
          "profiler device us per call): " + "; ".join(
              f"{n_}^3 ({v['shape']}): " + ", ".join(
                  f"{k} {t[0]:.4f} ms {t[1]:.2f} us" for k, t in v.items()
                  if k != "shape") for n_, v in stab_cmp.items())
          + f"; {GRID_HI}^3 real (ray, candidate) pairs tested (the chunks not "
          f"skipped): gen-7 {work7[2]}, gen-6 {work6[2]}; {card}")
    print(f"phase 18 fold + extraction at {GRID_HI}^3 (gen-7 tables): "
          f"{fold7_ms[0]:.4f} ms, {fold7_ms[1]:.2f} us device per call, "
          f"{fold7_cold_us:.2f} us with the L2 flushed; bound {bound7[0]:.6f} "
          f"ms ({bound7[1]}; {work7[0]} real rays, {work7[1]} candidate rows "
          f"and {work7[2]} real pairs in the chunks not skipped), "
          f"{bound7[0] / fold7_ms[0]:.4f} of it by CUDA events; {card}")

    # ---- 19. the new frames: 256^3 ray-stab and -normals (gen-7), and the
    # deforming ray-stab frames (refits) at 256^3 and 64^3 ----------------
    new_frames = {}
    for name, c_, deforming in (
            ("raystab 256", cfg_hi.replace(inside_mode="raystab"), False),
            ("normals 256", cfg_hi.replace(parity_normals=True), False),
            ("raystab 256 -deform", cfg_hi.replace(inside_mode="raystab"), True),
            ("raystab 64 -deform", cfg_hi.replace(inside_mode="raystab",
                                                  grid_size=GRID), True)):
        p_ = FramePipeline(c_, mb7, deforming=deforming)
        if deforming:
            p_.mesh = wobbled(mb7, base_x, 3)
        img_, first_s = timed(lambda p_=p_: p_.frame(consts7))
        check(bool(torch.isfinite(img_).all()) and img_.shape == (720, 1280, 3),
              f"{name} frame not finite or misshapen")
        err_ = None
        if name == "raystab 256":
            occ_, rgba_ = rst.raystab_query7(p_._stab_accel, use_kernels=False)
            grid_ = VoxelGrid(words=pack_bits_z(occ_),
                              rgba=quantize_r10g10b10a2(rgba_))
            err_ = max_err(img_, render(grid_, consts7, c_, use_kernels=False))
            check(err_ <= TOL_FRAME, f"{name} frame differs by {err_:.3g}")
        fn_ = lambda p_=p_: p_.frame(consts7)  # noqa: E731
        ms_ = cuda_ms(fn_)
        p_.sync()
        torch.cuda.reset_peak_memory_stats()
        prof = profile_frames(fn_, p_.sync, kernels)
        new_frames[name] = (ms_, *prof, torch.cuda.max_memory_allocated() / 2**20,
                            first_s, err_)
        del p_
    for name, (ms_, busy, per_frame, kus, peak, first_s, err_) in new_frames.items():
        print(f"phase 19 frame {name} 1280x720 -hq ({tc7} tris): {ms_:.4f} ms "
              f"with the kernels (CUDA events over {INNER} back-to-back runs, "
              f"median of {REPS}); first frame (accel from the cache filled by "
              f"phase 17, or the refitter built) {first_s:.4f} s"
              + ("" if err_ is None else f"; max|err| kernels vs plain {err_:.3g}")
              + f"; profiled: device busy {busy:.4f} ms per frame (idle share "
              f"{1 - busy / ms_:.3f}), {per_frame:.0f} device kernels and "
              f"copies per frame, kernel device us per frame {kus}, peak device "
              f"memory {peak:.1f} MiB; {card}")

    # ---- 20. the render variants and the rest of the app shell ----------
    p20 = phase20(torch, app_main, kernels, card, dev, {
        "64": (cfg, mb, consts), "256": (cfg_hi, mb7, consts7),
        "mesh6": (v6, t6), "cases": cases})
    for k, c in p20["launches"].items():
        main_launches[k] += c
    errs.update(p20["errs"])
    ms.update(p20["ms"])
    library_ms.update(p20["library"])

    # ---- 21. multi-device frames, batch datagen, the native tier --------
    p21 = phase21(torch, app_main, kernels, card, dev, {
        "64": (cfg, mb, consts), "256": (cfg_hi, mb7, consts7),
        "meshes": meshes, "mesh7": (v7 * WORLD_SCALE + WORLD_CENTER, t7),
        "native_builds": native_builds})
    for k, c in p21["launches"].items():
        main_launches[k] += c

    # ---- 22. the port's benchmark, as a user runs it ---------------------
    p22_launches, p22_errs = phase22(torch, root)
    for k, c in p22_launches.items():
        main_launches[k] += c
    for k, e in p22_errs.items():
        errs[k] = max(errs[k], e)

    # ---- 22b. the light recurrences' kernel ---------------------------------
    p22b = phase22b(torch, app_main, kernels, card, dev, {
        "64": (vols[0], consts.local_space_light_pt),
        "256": (vols7[0], consts7.local_space_light_pt),
        "mesh6": (v6, t6), "mesh7": (v7, t7), "cases": cases,
        "parent": args.parent})
    for k, c in p22b["launches"].items():
        main_launches[k] += c
    errs.update(p22b["errs"])
    ms.update(p22b["ms"])

    # ---- 22c. the grid glue's kernels -----------------------------------
    p22c = phase22c(torch, kernels, card, dev, {
        "64": (cfg, mb, consts), "256": (cfg_hi, mb7, consts7), "near": near,
        "cases": cases})
    for k, c in p22c["launches"].items():
        main_launches[k] += c
    errs.update(p22c["errs"])
    ms.update(p22c["ms"])
    library_ms.update(p22c["library"])

    # ---- 23. the benchmark's cells ---------------------------------------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    phase23(root, p22c["glue_by_cell"])

    # ---- bounds: the least time for each kernel's work on this run's data
    w64 = GRID * GRID * (GRID // 32) * 4
    w256 = GRID_HI * GRID_HI * (GRID_HI // 32) * 4
    rows_b, rows_q = real_rows(coef_main), real_rows(sv.coefs)
    pairs_q = bbox_pairs(torch, mb7.positions_norm, mb7.tris, GRID_HI)
    bounds = {
        "parity_voxelize": bound(rows_b * 64 + w64,
                                 pairs_b * PARITY_OPS_PER_PAIR),
        "parity_queue": bound(rows_q * 64 + sv.chunk_tile.numel() * 8 + w256,
                              pairs_q * PARITY_OPS_PER_PAIR),
        "march": march_bound(torch, mi),
        "resolve": resolve_bound(res_args),
        "raystab_fold_extract": raystab_bound(tb_rs, work_rs, True),
        "raystab_fold": raystab_bound(tb_rs, work_rs, False),
        "raystab_mt": bound(bytes1, ops1),
        **p20["bounds"],
        **p22b["bounds"],
        **p22c["bounds"],
    }
    dev_call_us = {"parity_voxelize": p_dev_us, "parity_queue": q_dev_us[GRID_HI],
                   **rs_dev_us, "raystab_mt": mt_dev_us}
    print("share of the bound (bound ms over ms per call, by device time and "
          "by CUDA events; the profiler's device time 'not measured' where its "
          "windows recorded none): " + ", ".join(
              f"{k} {f'{bounds[k][0] / (us / 1e3):.4f}' if us > 0 else 'not measured'}"
              f" / {bounds[k][0] / ms[k][0]:.4f}" for k, us in dev_call_us.items()))
    print(f"bounds (ms, bound by): {bounds}; binned {GRID}^3 {rows_b} real "
          f"rows, {pairs_b} (column, triangle) pairs in bounding boxes; "
          f"queue {GRID_HI}^3 {rows_q} real rows, {pairs_q} pairs; march "
          f"{tuple(mi.slabs.shape)} slabs, {mi.slabs.shape[1] * mi.ss} "
          f"sub-slabs, m={m}; resolve {resolve_hits(res_args)} of "
          f"{cfg.width * cfg.height} pixels hit, {SCREEN_MAP_OPS_PER_PIXEL} "
          f"mapping operations per pixel")

    result = {"kernels": [
        {"name": k.name, "route": k.route, "source": k.source,
         "replaces": k.replaces, "launches": main_launches[k.name],
         "max_abs_err": errs[k.name], "ms": ms[k.name][0],
         "plain_ms": ms[k.name][1], "bound_ms": bounds[k.name][0],
         "bound_by": bounds[k.name][1],
         "library_ms": library_ms.get(k.name)}
        for k in kernels
    ]}
    print(f"chip_smoke took {time.perf_counter() - t_smoke:.1f} s")
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
