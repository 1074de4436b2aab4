"""Synthetic strip tables that stress the ray-stab fold kernel
(csrc/raystab_fold.cu) at its boundaries, built from a real gen-6 accel; a
slice stream that stresses the Moller-Trumbore kernel's rejects
(csrc/raystab_mt.cu); triangle soups that stress a bounding box (the parity
kernels' spans); the gather renderer's cameras and 4-level alpha grids;
the settings of the redesigned kernels' timing sweeps; and the lights of
the light recurrences (csrc/light_sweep.cu).

Shared by ``tests/test_torch_cuda.py``, ``tests/test_torch_raystab.py`` (the
plain fold, on the CPU) and ``chip_smoke.py`` (which loads this file by
path). numpy and the port only.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from dxrvoxelizer_tpu_torch.ops import raystab_cuda as rsc
from dxrvoxelizer_tpu_torch.ops import raystab_fast as rsf
from dxrvoxelizer_tpu_torch.ops import raystab_mt_cuda as rmt

_spec = importlib.util.spec_from_file_location(
    "dxv_test_meshes", Path(__file__).resolve().parent / "meshes.py")
_meshes = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_meshes)

N = 64  # grid of the base accel
TIE_AT = 300  # first duplicate row: past a chunk (256), across a sub-chunk (320)
SHELL0, SHELL_STEP = 0.3, 0.05  # radii of the concentric shells
FORCED = (3, 7)  # chunks of the many-chunk strip bounded by 0: never skipped
# the timing sweeps' settings, each held bit for bit to the plain version:
# the fold kernel's (groups of 128 lanes per strip, ring stages, deferred
# division) and the queue kernel's (a block per tile run, else a block per
# chunk with atomics; threads)
FOLD_VARIANTS = [(g, st, d) for g in (1, 2, 4) for st in (1, 2, 3)
                 for d in (False, True)]
QUEUE_VARIANTS = [(True, 128), (True, 256), (True, 512), (False, 128),
                  (False, 256)]
# the binned parity kernel's (layout, blocks per tile, threads per block): a
# cluster per tile, blocks with device-memory atomics, the parent's
# every-column layout (one thread per column)
PARITY_VARIANTS = [("tile", 1, 256), ("tile", 4, 256), ("tile", 8, 256),
                   ("tile", 16, 256), ("tile", 8, 512), ("tile", 16, 512),
                   ("split", 16, 256), ("split", 64, 256), ("column", 1, 1024)]
# the Moller-Trumbore kernel's (threads per block, deferred division, rows
# staged through shared memory), run on slice streams of each width
MT_VARIANTS = [(th, d, st) for th in (128, 256) for d in (False, True)
               for st in (False, True)]


@dataclass
class StressCase:
    """``tables``: one strip stream of every case; ``t_count``: one past the
    largest id; ``strips``: case name -> its strips; ``lowest``:
    [S, 128] int32, the id the tie strips' lanes must end with (-1: no
    constraint); ``many_chunks``: the many-chunk strip's chunk count."""

    tables: rsc.StripTables
    t_count: int
    strips: dict
    lowest: torch.Tensor
    many_chunks: int


def _base():
    """The widest strip of a 1,280-triangle icosphere's gen-6 accel at 64^3,
    and the fused-row builder of that mesh."""
    v, nr, t = _meshes.icosphere_mesh(3)
    tv, tn, tt = (torch.from_numpy(v), torch.from_numpy(nr),
                  torch.from_numpy(t.astype(np.int64)))
    main = rsf.build_raystab_accel2(tv, tt, tn, n=N).main
    s = int(torch.argmax(main.cand_cnt))
    off, cnt = int(main.cand_off[s]), int(main.cand_cnt[s])
    rows = main.rows[off:off + cnt].clone()
    ids = rows[:, rsc.ID_COL].long()

    def shell(f):  # the same candidates on the mesh scaled by f
        return rsf._fused_coef_matrix(tv * f, tt, tn)[ids]

    return main.rays[s].clone(), rows, shell, int(tt.shape[0])


def _pad_rows(k):
    rows = torch.zeros((k, rsc.NROW), dtype=torch.float32)
    rows[:, rsc.ID_COL] = 2.0 ** 30  # a miss, whatever it meets
    return rows


def stab_stress(device) -> StressCase:
    rays0, rows0, shell, t = _base()
    m = rows0.shape[0]
    strips, lowest, groups = {}, [], []  # groups: (rays, rows, bounds)

    def add(name, rays, rows, bounds=None, low=None):
        strips.setdefault(name, []).append(len(groups))
        groups.append((rays, rows, bounds))
        lowest.append(torch.full((rsc.LANES,), -1, dtype=torch.int32)
                      if low is None else low)

    # ---- equal t under different ids: the lowest id wins, wherever it is
    hi_rows = rows0.clone()
    hi_rows[:, rsc.ID_COL] += 2 * t  # same geometry, higher ids
    fill = _pad_rows(TIE_AT - m)
    _, i_lo = rsc.fold_plain(rsc.StripTables(
        rays0[None], torch.zeros(1, dtype=torch.int32),
        torch.tensor([m], dtype=torch.int32), rows0))
    want = torch.where(i_lo[0] < t, i_lo[0], -1)
    add("ties", rays0, torch.cat([hi_rows, fill, rows0]), low=want)
    add("ties", rays0, torch.cat([rows0, fill, hi_rows]), low=want)
    inter = torch.stack([hi_rows, rows0], 1).reshape(2 * m, rsc.NROW)
    add("ties", rays0, torch.cat([_pad_rows(60), inter]), low=want)

    # ---- many chunks, near to far: shells of the same candidates; every
    # real lane hits the nearest, so a chunk is skipped unless some lane's
    # best t reaches its bound, which is strict (the nearest hit in it, one
    # ulp down) or 0 (FORCED: always run)
    rays = rays0.clone()
    real = ~((rays[0] == 0) & (rays[1] == 0) & (rays[2] == 0))
    rays[3] = torch.where(real, 0.1 + 0.01 * torch.arange(rsc.LANES) / rsc.LANES,
                          0.0)
    k_shells = -(-(8 * rsc.K_BLOCK + 100) // m)
    sh = [shell(SHELL0 + SHELL_STEP * k) for k in range(k_shells)]
    for k, r in enumerate(sh):
        r[:, rsc.ID_COL] += k * t
    t0, _ = rsc.fold_plain(rsc.StripTables(
        rays[None], torch.zeros(1, dtype=torch.int32),
        torch.tensor([m], dtype=torch.int32), sh[0]))
    rays[:, ~torch.isfinite(t0[0])] = 0.0  # lanes that miss: padding
    rows = torch.cat(sh)
    n_chunks = -(-rows.shape[0] // rsc.K_BLOCK)
    bounds = torch.full((n_chunks,), float("-inf"))
    for j in range(1, n_chunks):
        part = rows[j * rsc.K_BLOCK:(j + 1) * rsc.K_BLOCK]
        tj, _ = rsc.fold_plain(rsc.StripTables(
            rays[None], torch.zeros(1, dtype=torch.int32),
            torch.tensor([part.shape[0]], dtype=torch.int32), part))
        tj = tj[torch.isfinite(tj)]
        bounds[j] = (torch.nextafter(tj.min(), torch.tensor(float("-inf")))
                     if tj.numel() else float("inf"))
    bounds[list(FORCED)] = 0.0
    add("many_chunks", rays, rows, bounds)

    # ---- padding only: every lane all-zero, with and without bounds
    zero = torch.zeros_like(rays0)
    add("padding", zero, rows0)
    add("padding", zero, rows, bounds)

    n_b = max(b.shape[0] for _, _, b in groups if b is not None)
    bnd = torch.full((len(groups), n_b), float("-inf"))
    for i, (_, _, b) in enumerate(groups):
        if b is not None:
            bnd[i, :b.shape[0]] = b
    cnt = torch.tensor([g[1].shape[0] for g in groups], dtype=torch.int32)
    off = torch.cumsum(cnt, 0, dtype=torch.int32) - cnt
    tables = rsc.StripTables(
        rays=torch.stack([g[0] for g in groups]).contiguous().to(device),
        cand_off=off.to(device), cand_cnt=cnt.to(device),
        rows=torch.cat([g[1] for g in groups]).contiguous().to(device),
        bounds=bnd.to(device))
    return StressCase(tables, max(3, k_shells) * t, strips,
                      torch.stack(lowest).to(device), n_chunks)


def by_id(tb: rsc.StripTables) -> rsc.StripTables:
    """The stream in the row-id form: its distinct rows (bit patterns) as the
    table, in another order than the stream's, and each candidate's id into
    it; it stands for the same candidate rows."""
    bits, ids = torch.unique(tb.rows.view(torch.int32), dim=0,
                             return_inverse=True)
    table = bits.view(torch.float32).flip(0).contiguous()
    ids = (table.shape[0] - 1 - ids).to(torch.int32)
    return dataclasses.replace(tb, rows=table, row_ids=ids)


def _folds(tb, t_count, rule):
    """(t, id, ns) of the plain fold + extraction and (t, id) of the plain
    fold alone on one stream."""
    return (*rsc.fold_extract_plain(tb, t_count, 0.12, rule), *rsc.fold_plain(tb))


def assert_folds_equal(by_id: rsc.StripTables, rows: rsc.StripTables,
                       t_count: int, rule: str) -> None:
    """The plain kernels on a row-id stream and on the materialised stream it
    stands for, bit for bit: whole, in two strip slices, and on every other
    strip as ``benchmark/work.py`` cuts sub-tables (``dataclasses.replace``
    of rays, offsets, counts and bounds)."""
    whole = _folds(by_id, t_count, rule)
    for a, b in zip(whole, _folds(rows, t_count, rule)):
        assert torch.equal(a, b)
    half = by_id.strips // 2
    parts = [_folds(rsc.strip_slice(by_id, lo, hi), t_count, rule)
             for lo, hi in ((0, half), (half, by_id.strips))]
    for a, *pieces in zip(whole, *parts):
        assert torch.equal(a, torch.cat(pieces))
    sel = torch.arange(0, by_id.strips, 2, device=by_id.rays.device)

    def sub(tb):
        return dataclasses.replace(
            tb, rays=tb.rays[sel], cand_off=tb.cand_off[sel],
            cand_cnt=tb.cand_cnt[sel],
            bounds=None if tb.bounds is None else tb.bounds[sel])

    assert sub(by_id).row_ids is by_id.row_ids
    for a, b in zip(_folds(sub(by_id), t_count, rule),
                    _folds(sub(rows), t_count, rule)):
        assert torch.equal(a, b)


def chunks_run(tb: rsc.StripTables, strip: int) -> list[bool]:
    """Which chunks of ``strip`` the fold tests: a chunk runs unless every
    lane's best t over the chunks before it is below its bound (replayed
    with the plain fold)."""
    one = dataclasses.replace(
        tb, rays=tb.rays[strip:strip + 1], cand_off=tb.cand_off[strip:strip + 1],
        cand_cnt=tb.cand_cnt[strip:strip + 1], bounds=tb.bounds[strip:strip + 1])
    cnt = int(one.cand_cnt[0])
    runs = []
    for j in range(-(-cnt // rsc.K_BLOCK)):
        head = dataclasses.replace(one, cand_cnt=torch.clamp(
            one.cand_cnt, max=j * rsc.K_BLOCK))
        best, _ = rsc.fold_plain(head)
        bound = one.bounds[0, j] if j < one.bounds.shape[1] else float("-inf")
        runs.append(bool((best >= bound).any()))
    return runs


def needle_soup(rng, n, t):
    """Triangles that stress a bounding box: random ones; ones with every
    vertex on a voxel centre (edge and vertex ties); slivers, a vertex a hair
    off the opposite edge; collinear ones in x-y (zero projected area); and
    needles spanning the grid."""
    def centre(i):
        return (i + 0.5) / n * 2.0 - 1.0

    rand = rng.uniform(-0.9, 0.9, (t, 1, 3)) + rng.normal(0, 0.08, (t, 3, 3))
    on_c = centre(rng.integers(0, n, (t, 3, 3)).astype(np.float64))
    a, b = on_c[:, 0], on_c[:, 1]
    u = rng.uniform(0, 1, (t, 1))
    perp = np.stack([-(b - a)[:, 1], (b - a)[:, 0], np.zeros(t)], 1)
    eps = 10.0 ** rng.uniform(-7, -2, (t, 1))
    sliver = np.stack([a, b, a + u * (b - a) + eps * perp], 1)
    line = np.stack([a, b, a + u * (b - a)], 1)
    line[:, 2, 2] += rng.uniform(-0.5, 0.5, t)
    needle = np.stack([a, -a + eps * perp, a + eps], 1)
    v = np.concatenate([rand, on_c, sliver, line, needle]).astype(np.float32)
    v = np.clip(v, -1.0, 1.0).reshape(-1, 3)
    return v, np.arange(v.shape[0], dtype=np.int32).reshape(-1, 3)


# the needle soups whose stray crossings fall outside both packages' binning
# at 64^3 (ROADMAP, "Differences that are not faults"): needle_soup seeds
SOUP_SEEDS = (287, 289)
SOUP_TRIS = 24

# ---- the Moller-Trumbore kernel's stress stream ------------------------------

TINY = 2.0 ** -149  # the least float32 subnormal


def _right(a, b, dz, origins, v0=(0.0, 0.0, 0.0)):
    """Rays (origins, direction (0, 0, dz)) against the right triangle v0,
    e1 = (a, 0, 0), e2 = (0, b, 0): det = -a b dz, u = tv_x / a, v = tv_y / b
    and t = -tv_z / dz, each the Moller-Trumbore expression's rounding of
    them -> (o [R, 3], d [R, 3], rows [1, 9])."""
    o = np.asarray(origins, np.float32).reshape(-1, 3)
    d = np.tile(np.float32([0.0, 0.0, dz]), (o.shape[0], 1))
    row = np.float32([*v0, a, 0.0, 0.0, 0.0, b, 0.0])[None]
    return o, d, row


def mt_stress_groups() -> dict:
    """Groups of rays against rows (numpy f32: o [R, 3], d [R, 3], rows
    [K, 9] v0 e1 e2) at the hazards of the deferred division, by name:
    det near +-1e-10; u_num and v_num at +-0 and at magnitudes whose product
    with 1/det underflows to -0.0 (which passes u >= 0) or not; u + v within
    a few ulp of 1, with det 1 and 9; equal t on distinct ids (one geometry
    twice, and two triangles sharing an edge), higher ids first; t at +-0,
    at 1e4 and one ulp past it; every group also with its axes permuted
    cyclically and with e1 and e2 swapped (det's sign flipped, u and v
    trading places); a random soup of 150 rows (more
    than a staged round) against 200 rays (several slices), and rays with
    no row."""
    g = {}
    # |det| = a b around 1e-10 (float32(1e-10) is the threshold)
    a = np.float32(1e-5) * (1.0 + np.arange(-6, 7) * 2.0 ** -22)
    rows = np.float32([[0.0, 0.0, 0.0, x, 0.0, 0.0, 0.0, 1e-5, 0.0] for x in a])
    o = np.float32([[u * 1e-5, v * 1e-5, 0.5] for u in (0.0, 0.25, 0.5)
                    for v in (0.0, 0.25, 0.5)])
    g["det"] = (o, np.tile(np.float32([0.0, 0.0, -1.0]), (len(o), 1)), rows)
    # u underflows with det 4 (u = rn(u_num / 4)), v with b = 4
    k = np.arange(-4, 5) * TINY
    g["u_underflow"] = _right(4.0, 1.0, -1.0, [[x, 0.25, 0.5] for x in k])
    g["v_underflow"] = _right(1.0, 4.0, -1.0, [[0.25, y, 0.5] for y in k])
    g["zeros"] = _right(1.0, 1.0, -1.0, [[x, y, 0.5] for x in (0.0, -0.0, TINY)
                                         for y in (0.0, -0.0, -TINY)])
    # u + v around 1: det 1 (u = ox, v = oy exactly) and det 9
    ulp = np.arange(-3, 4)
    g["sum_det1"] = _right(1.0, 1.0, -1.0, [
        [0.5 + i * 2.0 ** -24, 0.5 + j * 2.0 ** -25, 0.5] for i in ulp for j in ulp])
    g["sum_det9"] = _right(3.0, 3.0, -1.0, [
        [1.5 + i * 2.0 ** -22, 1.5 + j * 2.0 ** -22, 0.5] for i in ulp for j in ulp])
    # t at +-0, 1e4, past 1e4 and just below 0
    big = np.float32(1e4)
    g["t_bounds"] = _right(1.0, 1.0, -1.0, [
        [0.25, 0.25, z] for z in (0.0, -0.0, TINY, -TINY, big,
                                  np.nextafter(big, np.float32(np.inf)))])
    # equal t: one geometry twice; two triangles sharing the diagonal of a
    # unit square, the ray through a point of it
    o, d, r = _right(1.0, 1.0, -1.0, [[0.25, 0.5, 0.5], [0.5, 0.5, 0.5]])
    other = np.float32([[1.0, 1.0, 0.0, -1.0, 0.0, 0.0, 0.0, -1.0, 0.0]])
    g["ties"] = (o, d, np.concatenate([r, r, other, r]))
    for name in list(g):  # cyclic axis permutation, and det's sign flipped
        o, d, r = g[name]
        perm = [1, 2, 0]
        g[name + "_yzx"] = (o[:, perm], d[:, perm], r.reshape(-1, 3, 3)[:, :, perm]
                            .reshape(-1, 9))
        g[name + "_flip"] = (o, d, r[:, [0, 1, 2, 6, 7, 8, 3, 4, 5]])  # e1 <-> e2
    rng = np.random.default_rng(7)
    v = rng.uniform(-1, 1, (150, 1, 3)) + rng.normal(0, 0.3, (150, 3, 3))
    soup = np.concatenate([v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], 1)
    o = rng.uniform(-0.5, 0.5, (200, 3))
    d = rng.normal(0, 1, (200, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    g["soup"] = (o.astype(np.float32), d.astype(np.float32),
                 soup.astype(np.float32))
    g["no_rows"] = (o[:40].astype(np.float32), d[:40].astype(np.float32),
                    np.zeros((0, 9), np.float32))
    return g


def mt_stress(device, lanes: int = rmt.LANES) -> rmt.MTTables:
    """The groups of :func:`mt_stress_groups` as one slice stream of
    ``lanes``-wide slices; each row's id is distinct, and within a group the
    ids fall (row k of a group of K rows: id base + K - 1 - k), so an equal
    t is won by a later row."""
    groups = list(mt_stress_groups().values())
    nray = np.array([len(o) for o, _, _ in groups])
    ncand = np.array([len(r) for _, _, r in groups])
    rows = np.zeros((ncand.sum(), rmt.NROW), np.float32)
    rows[:, :9] = np.concatenate([r for _, _, r in groups])
    c_start = np.cumsum(ncand) - ncand
    rows[:, rmt.ID_COL] = (np.repeat(c_start + ncand - 1, ncand)
                           - (np.arange(ncand.sum()) - np.repeat(c_start, ncand)))
    pos = torch.from_numpy(np.concatenate([o for o, _, _ in groups])).to(device)
    dirs = torch.from_numpy(np.concatenate([d for _, d, _ in groups])).to(device)
    return rmt.slice_stream(pos, dirs, torch.from_numpy(rows).to(device),
                            np.arange(nray.sum()), np.cumsum(nray) - nray, nray,
                            c_start, ncand, lanes)


# ---- the gather renderer's inputs -------------------------------------------

def gather_cameras(w: int, h: int) -> dict:
    """Cameras of the gather march, name -> (screen_to_local [4, 4], eye,
    light), local space, row-vector convention:

    - "frame": the app's orbit camera on a bound of half extent 2 at (0, 4,
      0) (a box's footprint on the screen);
    - "inside": the same camera on a bound of half extent 3 around the eye,
      so every near-plane point lies inside the box (the inside case);
    - "axis": a parallel view along +z from x = 0.25 (every direction's x
      is exactly 0: the d_i == 0 case), and for an odd ``h`` a middle row
      along the z axis itself.
    """
    from dxrvoxelizer_tpu_torch.models.camera import OrbitCamera
    from dxrvoxelizer_tpu_torch.utils import dxmath as dxm

    cam = OrbitCamera(w, h)
    light_w = np.array([-10.0, 45.0, -75.0], np.float32)
    out = {}
    for name, bnd in (("frame", (0.0, 4.0, 0.0, 2.0)),
                      ("inside", (8.0, 12.0, -13.5, 3.0))):
        world = dxm.world_matrix(np.array(bnd, np.float32),
                                 np.array([0, 0, 0, 1], np.float32))
        inv = dxm.inverse(world)
        out[name] = (dxm.screen_to_local(world, cam.view_proj, w, h),
                     dxm.transform_coord(cam.eye, inv),
                     dxm.transform_coord(light_w, inv))
    k = np.float32(2.0 ** -np.ceil(np.log2(max(w, h) / 2.5)))  # dyadic pitch
    s2l = np.zeros((4, 4), np.float32)
    s2l[1, 1] = s2l[0, 2] = k  # y from the row, z from the column
    s2l[3] = (0.25, -np.float32(h / 2) * k, -3.0 - np.float32(w / 2) * k, 1.0)
    out["axis"] = (s2l, np.array([0.25, 0.0, -5.0], np.float32),
                   out["frame"][2])
    return out


def alpha_grid(n: int, seed: int, device) -> torch.Tensor:
    """A ray-stab grid's density: R10G10B10A2 alpha, 4 levels k / 3 (the
    rounding of ``packing.quantize_r10g10b10a2``), in clumps of 4^3."""
    g = torch.Generator().manual_seed(seed)
    c = torch.randint(0, 4, (n // 4, n // 4, n // 4), generator=g)
    c = c * (torch.rand(c.shape, generator=g) < 0.35)
    k = c.repeat_interleave(4, 0).repeat_interleave(4, 1).repeat_interleave(4, 2)
    return (k.to(torch.float32) / 3.0).to(device)


# ---- the light recurrences (ops/raymarch_warp.py light_sweep_ref,
# light_sweep and light_sweep_point, csrc/light_sweep.cu) ---------------------

# lights (local space) that, with the render tests' four, give every major
# tex axis and flip both the reference-step windows d0 = 2 and 3 at 64^3
# (every light gives d0 = 1 at 32^3; 64^3 cannot give 1)
SWEEP_LIGHTS = [(-40.0, 5.0, -3.0), (7.0, 4.0, -5.0), (-7.0, -5.0, 4.0),
                (-6.0, 9.0, 4.0), (2.0, -20.0, 5.0), (1.0, 25.0, -2.0),
                (-5.0, -7.0, 4.0), (3.0, 2.0, 30.0), (-5.0, 6.0, -30.0)]


def cell_light(config: str) -> tuple:
    """The local-space light of a configuration of BENCHMARK.json, as its
    cell's scene computes it (the torus placed as benchmark/run.py places
    it; the light does not move with the camera or the wobble)."""
    import json

    from benchmark.run import (ROOT, WORLD_CENTER, WORLD_SCALE, torus_mesh)
    from dxrvoxelizer_tpu_torch.utils import dxmath as dxm
    from dxrvoxelizer_tpu_torch.utils.config import VoxelizerConfig

    c = json.loads((ROOT / "BENCHMARK.json").read_text())["configs"][config]
    assert c["settings"]["mesh"] == "torus", config
    cfg = VoxelizerConfig(**{**c["settings"], "mesh": "torus.obj"})
    v, _ = torus_mesh(tuple(c["torus_segments"]))
    v = (v * WORLD_SCALE + WORLD_CENTER).astype(np.float32)
    lo, hi = v.min(0), v.max(0)
    bound = np.array([*((lo + hi) * 0.5), float(np.max(hi - lo)) * 0.5],
                     np.float32)
    world = dxm.world_matrix(bound, np.asarray(cfg.pos_scale, np.float32))
    light = dxm.transform_coord(np.asarray(cfg.light_pt, np.float32),
                                dxm.inverse(world))
    return tuple(float(x) for x in np.asarray(light, np.float32))


def d0_light(axis: int, sign: float, d0: int, n: int) -> tuple:
    """A light whose reference step at ``n`` has major tex axis ``axis``
    (the direction's sign along it ``sign``) and window ``d0``: the major
    component mid-way between d0 and d0 + 1 slabs per step, the other two
    unequal and smaller."""
    from dxrvoxelizer_tpu_torch.ops.raymarch_warp import light_ref_statics

    per_unit = n * np.sqrt(3.0) / 32.0  # slabs per step along a unit axis
    c = (d0 + 0.5) / per_unit
    rest = np.sqrt(1.0 - c * c)
    v = np.zeros(3)
    v[axis] = sign * c
    others = [a for a in range(3) if a != axis]
    v[others[0]], v[others[1]] = 0.72 * rest, -0.694 * rest
    light = tuple(float(x) for x in (40.0 * v).astype(np.float32))
    got = light_ref_statics(np.asarray(light, np.float32), n)
    assert got[0] == axis and got[2] == d0, (light, got)
    return light


# the point light's kinds (X.5): "far", the app's default light_pt
# (-10, 45, -75) taken as a local-space point, moved to each major axis and
# side; "near", 1.25 texels past the far face (the host sweeps from 1 texel
# on), where the tap map contracts most (a_k down to 0.43 at the last slab);
# "off", off-axis, the other two components nearly as far out as the major
# one, so that many taps fall outside the volume
POINT_KINDS = ("far", "near", "off")


def point_light(axis: int, sign: float, kind: str, n: int) -> tuple:
    """A point light (local space) whose slab sweep at ``n`` runs along tex
    axis ``axis``, the light on its ``sign`` side, of kind ``kind``
    (POINT_KINDS); checked against the host's rule
    (``raymarch_warp.point_light_statics``)."""
    from dxrvoxelizer_tpu_torch.ops.raymarch_ref import TEX_SCALE
    from dxrvoxelizer_tpu_torch.ops.raymarch_warp import point_light_statics

    # l_t - 0.5 in tex space: the major component, then the other two
    major, rest = {"far": (37.5, (-5.0, -22.5)),
                   "near": (0.5 + 1.25 / n, (0.1, -0.15)),
                   "off": (2.0, (1.9, -1.8))}[kind]
    rel = np.zeros(3)
    rel[axis] = sign * major
    others = [a for a in range(3) if a != axis]
    rel[others[0]], rel[others[1]] = rest
    light = tuple(float(x) for x in
                  (rel / np.asarray(TEX_SCALE, np.float64)).astype(np.float32))
    got = point_light_statics(np.asarray(light, np.float32), n)
    assert got == (axis, sign < 0, True), (light, got)
    return light


def point_lights(n: int, kinds=POINT_KINDS) -> list:
    """Point lights of every major tex axis and side, of each kind."""
    return [point_light(a, sg, kind, n) for kind in kinds for a in range(3)
            for sg in (1.0, -1.0)]


# ---- the grid glue (csrc/grid.cu): channels that stress the rounding -------

def _ties(levels: int) -> np.ndarray:
    """float32 values c in (0, 1) whose product c * levels is exactly
    m + 0.5 for each m < levels (the round-half-to-even ties), found by a
    search over the float32 neighbours of (m + 0.5) / levels."""
    f = np.float32
    out = []
    for m in range(levels):
        target = f(m) + f(0.5)
        c = f((m + 0.5) / levels)
        for step in range(64):
            for s in (c, np.nextafter(c, f(2)), np.nextafter(c, f(-1))):
                if f(s * f(levels)) == target:
                    out.append(s)
                    break
            else:
                c = np.nextafter(c, f(2) if f(c * f(levels)) < target else f(-1))
                continue
            break
    return np.asarray(out, np.float32)


def quantize_cases() -> np.ndarray:
    """Channel values for R10G10B10A2 [C] float32: the exact .5 ties of both
    widths, every level k / 1023 and k / 3 (as a true quotient and as the
    product by the float32 reciprocal), their float32 neighbours,
    negatives, values above 1, signed zeros, infinities and NaN."""
    f = np.float32
    k = np.arange(1024, dtype=f)
    lv = np.concatenate([k / f(1023), k * (f(1) / f(1023)),
                         k[:4] / f(3), k[:4] * (f(1) / f(3))])
    base = np.concatenate([_ties(1023), _ties(3), lv])
    near = np.concatenate([np.nextafter(base, f(2)), np.nextafter(base, f(-1))])
    odd = np.array([-0.0, 0.0, -1e-30, -0.25, -1.0, 1.0 + 2 ** -23, 1.5, 7.0,
                    np.inf, -np.inf, np.nan, 2 ** -149, -(2 ** -149)], f)
    return np.concatenate([base, near, odd, -base[:200]]).astype(f)


def grid_channels(n: int, seed: int, live: float = 0.7,
                  tiles: bool = True) -> dict:
    """Channels for X.6 at n^3 (seeded): the live tiles' ``ns`` [L, 128, 4]
    and their ``tids`` (a ``live`` share of the tiles, ascending) when
    ``tiles``, else a grid-order ``src`` [n^3, 4]; rgb drawn from
    :func:`quantize_cases` and normals in [-1.2, 1.2], alpha from
    {0, 1, the cases}; ``gate`` words [n, n, n/32] int32 with bit 31 set in
    some (None when n % 32)."""
    rng = np.random.default_rng(seed)
    cases = quantize_cases()
    count, rows = n ** 3 // 128, n ** 3
    rgb = np.where(rng.random((rows, 3)) < 0.5,
                   rng.choice(cases, (rows, 3)),
                   rng.uniform(-1.2, 1.2, (rows, 3))).astype(np.float32)
    pick = rng.random(rows)
    alpha = np.where(pick < 0.4, 0.0, np.where(pick < 0.8, 1.0,
                                               rng.choice(cases, rows)))
    ch = np.concatenate([rgb, alpha[:, None].astype(np.float32)], -1)
    out = {}
    if tiles:
        tids = np.nonzero(rng.random(count) < live)[0].astype(np.int64)
        out["tids"] = tids
        out["ns"] = ch.reshape(count, 128, 4)[: len(tids)].copy()
    else:
        out["src"] = ch
    if n % 32 == 0:
        g = rng.integers(0, 2 ** 32, (n, n, n // 32), dtype=np.uint64)
        g[0, 0, 0] = 0xFFFFFFFF
        g[-1, -1, -1] = 0x80000000
        out["gate"] = g.astype(np.uint32).view(np.int32)
    return out


def packed_outs(outs: dict) -> dict:
    """Each strip stream's (t, id, ns) as the sharded frames gather them:
    one [S, 128, 6] tensor (t, the id's bits, ns), handed back as the
    strided views X.10 reads in place."""
    g = {k: torch.cat([t[..., None], i.view(torch.float32)[..., None], ns], -1)
         for k, (t, i, ns) in outs.items()}
    return {k: (x[..., 0], x[..., 1].view(torch.int32), x[..., 2:])
            for k, x in g.items()}


def grid_order_streams(src: torch.Tensor, n: int):
    """Channels [n^3, 4] in grid order as X.10's input -> (accel, outs): a
    stand-in gen-6 accel whose ray -> slot map is the identity and a main
    stream [n^3 / 128, 128] of those channels (t 0, id 0), so that X.10
    gives what X.6's grid-order plain version gives from ``src``."""
    dev, v = src.device, n ** 3
    ray = torch.arange(v, device=dev)
    accel = SimpleNamespace(n=n, device=dev, ray_slot=ray.to(torch.int32),
                            slot_ray=ray)
    rows = (v // 128, 128)
    return accel, {"main": (torch.zeros(rows, device=dev),
                            torch.zeros(rows, dtype=torch.int32, device=dev),
                            src.reshape(*rows, 4))}
