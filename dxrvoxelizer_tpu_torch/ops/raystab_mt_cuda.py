"""Ray-stab Moller-Trumbore closest hit over per-cell candidate lists: the
CUDA kernel and its plain version (the gen-1 accel's query).

Port of ``_stab_kernel`` in ``dxrvoxelizer_tpu/ops/raystab_pallas.py``
(launched by ``stab_closest_hit``). A stream of slices covers every voxel
ray once: slice s holds at most ``lanes`` rays (32, 64 or 128; the accel's
slicing uses :data:`LANES`), ``ray_ids[ray_off[s] : ray_off[s] +
ray_cnt[s]]``, and tests them against its candidate rows
``rows[cand_off[s] : cand_off[s] + cand_cnt[s]]``, each 12 floats
``v0 e1 e2 id pad pad`` (ops/raystab_fast.py). Per ray: ``intersect.mt_hit``
against every candidate and the lexicographic (t, lowest id) minimum over
the hits. The overflow stream is the same layout: slices of all rays in
voxel order (``ray_ids`` = 0..V-1), every slice against all the overflow
rows. :func:`slice_stream` lays groups of rays and their rows out as one.

- :func:`closest_hit` is the wrapper: a CUDA tensor launches
  ``csrc/raystab_mt.cu``, a CPU tensor takes the plain version.
- :func:`closest_hit_plain` is the plain torch version, the JAX package's
  gather form of ``_query_cells`` (every batch of slices at once, the
  minimum by ``min`` reductions); on the overflow stream it gives
  ``_overflow_pass``'s (t, id), in any row order.
- :func:`mt_rejects` replays the kernel's rejects that need no division
  (tests only: they must never reject a pair ``mt_hit`` accepts).

Outputs per ray, in voxel order: t [V] f32 (+inf on a miss) and id [V]
int32 (2^30 on a miss); t is the winner's own value.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dxrvoxelizer_tpu_torch.ops import _cuda, intersect

LANES = 32  # rays per slice of the accel's stream (chip_smoke.py phase 16b)
SLICE_LANES = (32, 64, 128)  # the slice widths the kernel takes
NROW = 12  # floats per candidate row: v0 e1 e2 id pad pad
ID_COL = 9
PLAIN_PAIRS = 1 << 21  # (ray, candidate) lanes per step of the plain version
PLAIN_CHUNK = 256  # candidates per step of the plain version

KERNEL = _cuda.Kernel(
    name="raystab_mt",
    symbol="mt_kernel",
    source="dxrvoxelizer_tpu_torch/csrc/raystab_mt.cu",
    replaces="dxrvoxelizer_tpu/ops/raystab_pallas.py:101",
)


@dataclass
class MTTables:
    """One slice stream: ``pos``/``dirs`` [V,3] f32 the voxel rays in voxel
    order; ``ray_ids`` [R] int32 the rays in slice order; ``ray_off``,
    ``ray_cnt``, ``cand_off``, ``cand_cnt`` [W] int32 per slice; ``rows``
    [P,12] f32; ``lanes``: the most rays a slice holds (``ray_cnt`` <=
    ``lanes``, one of SLICE_LANES). The slices must cover every ray once."""

    pos: torch.Tensor
    dirs: torch.Tensor
    ray_ids: torch.Tensor
    ray_off: torch.Tensor
    ray_cnt: torch.Tensor
    cand_off: torch.Tensor
    cand_cnt: torch.Tensor
    rows: torch.Tensor
    lanes: int = 128

    @property
    def slices(self) -> int:
        return int(self.ray_off.shape[0])


def _check(tb: MTTables) -> None:
    v = tb.pos.shape[0]
    for name, x in (("pos", tb.pos), ("dirs", tb.dirs)):
        if tuple(x.shape) != (v, 3):
            raise ValueError(f"{name}: expected [{v}, 3], got {tuple(x.shape)}")
    if tb.rows.ndim != 2 or tb.rows.shape[1] != NROW:
        raise ValueError(f"rows: expected [P, {NROW}], got {tuple(tb.rows.shape)}")
    w = tb.slices
    for name, x in (("ray_off", tb.ray_off), ("ray_cnt", tb.ray_cnt),
                    ("cand_off", tb.cand_off), ("cand_cnt", tb.cand_cnt)):
        if tuple(x.shape) != (w,):
            raise ValueError(f"{name}: expected [{w}], got {tuple(x.shape)}")
    if tb.ray_ids.ndim != 1:
        raise ValueError(f"ray_ids: expected [R], got {tuple(tb.ray_ids.shape)}")
    if tb.lanes not in SLICE_LANES:
        raise ValueError(f"lanes: expected one of {SLICE_LANES}, got {tb.lanes}")


def _i32(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)


def slice_stream(pos, dirs, rows, ray_ids, r_start, nray, c_start, ncand,
                 lanes: int = LANES) -> MTTables:
    """Groups of rays and their candidate rows -> one slice stream.

    Group i tests the rays ``ray_ids[r_start[i] : r_start[i] + nray[i]]``
    against ``rows[c_start[i] : c_start[i] + ncand[i]]`` (numpy); a group of
    more than ``lanes`` rays becomes several slices over the same rows.
    Slices are ordered widest candidate list first. ``pos``, ``dirs`` and
    ``rows`` are tensors on the stream's device."""
    r_start, nray, c_start, ncand = (np.asarray(a, np.int64)
                                     for a in (r_start, nray, c_start, ncand))
    per = -(-nray // lanes)
    grp = np.repeat(np.arange(nray.size), per)
    within = (np.arange(grp.size) - np.repeat(np.cumsum(per) - per, per)) * lanes
    order = np.argsort(-ncand[grp], kind="stable")
    dev = pos.device
    return MTTables(
        pos=pos, dirs=dirs, ray_ids=_i32(ray_ids, dev),
        ray_off=_i32((r_start[grp] + within)[order], dev),
        ray_cnt=_i32(np.minimum(lanes, nray[grp] - within)[order], dev),
        cand_off=_i32(c_start[grp][order], dev),
        cand_cnt=_i32(ncand[grp][order], dev), rows=rows, lanes=lanes)


def closest_hit_plain(tb: MTTables):
    """Plain torch version of the closest-hit kernel -> (t [V], id [V] int32)."""
    _check(tb)
    dev = tb.pos.device
    v, p = tb.pos.shape[0], tb.rows.shape[0]
    inf, big = float("inf"), float(intersect.BIG_ID)
    zero = torch.zeros((1, 3), dtype=torch.float32, device=dev)
    pos_p, dirs_p = torch.cat([tb.pos, zero]), torch.cat([tb.dirs, zero])
    pad_row = torch.zeros((1, NROW), dtype=torch.float32, device=dev)
    pad_row[0, ID_COL] = big  # what a missing candidate tests as: a miss
    rows_p = torch.cat([tb.rows, pad_row])
    ray_ids = tb.ray_ids.to(torch.int64)
    t_out = torch.empty((v,), dtype=torch.float32, device=dev)
    i_out = torch.empty((v,), dtype=torch.int32, device=dev)
    # slices per step: the padded [slices, 128, candidates] block stays
    # under PLAIN_PAIRS lanes
    widest = min(PLAIN_CHUNK, max(1, int(tb.cand_cnt.max()) if tb.slices else 1))
    step = max(1, PLAIN_PAIRS // (tb.lanes * widest))
    for b0 in range(0, tb.slices, step):
        sl = slice(b0, b0 + step)
        roff, rcnt, coff, ccnt = (x[sl].to(torch.int64) for x in (
            tb.ray_off, tb.ray_cnt, tb.cand_off, tb.cand_cnt))
        lanes = torch.arange(int(rcnt.max()), device=dev)
        live = lanes[None, :] < rcnt[:, None]  # [B, L]
        rid = torch.where(live, ray_ids[torch.where(live, roff[:, None] + lanes, 0)], v)
        o, d = pos_p[rid][:, :, None, :], dirs_p[rid][:, :, None, :]  # [B,L,1,3]
        bt = torch.full(rid.shape, inf, dtype=torch.float32, device=dev)
        bi = torch.full_like(bt, big)
        width = min(PLAIN_CHUNK, int(ccnt.max()))
        for c0 in range(0, int(ccnt.max()), PLAIN_CHUNK):
            k = torch.arange(width, device=dev) + c0
            q = rows_p[torch.where(k[None, :] < ccnt[:, None], coff[:, None] + k, p)]
            q = q[:, None]  # [B,1,K,12]
            t, _, _, hit = intersect.mt_hit(o, d, q[..., 0:3], q[..., 3:6], q[..., 6:9])
            ii = torch.where(hit, q[..., ID_COL], big)  # [B,L,K]
            t_min = t.min(dim=-1).values
            i_min = torch.where(t == t_min[..., None], ii, big).min(dim=-1).values
            # the winner's own t (its sign of zero included)
            t_win = torch.where(ii == i_min[..., None], t, inf).min(dim=-1).values
            closer = (t_win < bt) | ((t_win == bt) & (i_min < bi))
            bt = torch.where(closer, t_win, bt)
            bi = torch.where(closer, i_min, bi)
        t_out[rid[live]] = bt[live]
        i_out[rid[live]] = bi[live].to(torch.int32)
    return t_out, i_out


def mt_rejects(o, d, v0, e1, e2) -> torch.Tensor:
    """The pairs csrc/raystab_mt.cu rejects before it divides, broadcasting
    over leading dims -> bool: |det| <= eps, or u_num (v_num) against det's
    sign by more than |det| 2^-64, or u_num + v_num (signs relative to det)
    above |det| (1 + 2^-16). ``mt_hit``'s expressions in its order; used
    only by the tests, which hold that no such pair is a hit."""
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    e1x, e1y, e1z = e1[..., 0], e1[..., 1], e1[..., 2]
    e2x, e2y, e2z = e2[..., 0], e2[..., 1], e2[..., 2]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    tvx, tvy, tvz = ox - v0[..., 0], oy - v0[..., 1], oz - v0[..., 2]
    un = tvx * px + tvy * py + tvz * pz
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    vn = dx * qx + dy * qy + dz * qz
    ad = det.abs()
    tiny = ad * 2.0 ** -64
    su, sv = torch.where(det > 0, un, -un), torch.where(det > 0, vn, -vn)
    return (~(ad > intersect.EPS_DET) | (su < -tiny) | (sv < -tiny)
            | (su + sv > ad * (1.0 + 2.0 ** -16)))


def _launch(tb: MTTables, variant):
    _check(tb)
    _cuda.require(tb.pos, "pos", torch.float32)
    _cuda.require(tb.dirs, "dirs", torch.float32)
    for name in ("ray_ids", "ray_off", "ray_cnt", "cand_off", "cand_cnt"):
        _cuda.require(getattr(tb, name), name, torch.int32)
    _cuda.require(tb.rows, "rows", torch.float32)
    if tb.rows.data_ptr() % 16:
        raise ValueError("rows: expected 16-byte alignment (float4 loads)")
    dev = tb.pos.device
    lib = _cuda.load()
    v = tb.pos.shape[0]
    t = torch.empty((v,), dtype=torch.float32, device=dev)
    i = torch.empty((v,), dtype=torch.int32, device=dev)
    args = (tb.pos.data_ptr(), tb.dirs.data_ptr(), tb.ray_ids.data_ptr(),
            tb.ray_off.data_ptr(), tb.ray_cnt.data_ptr(),
            tb.cand_off.data_ptr(), tb.cand_cnt.data_ptr(), tb.rows.data_ptr(),
            t.data_ptr(), i.data_ptr(), tb.slices, tb.lanes)
    if variant is None:
        code = lib.dxv_raystab_mt(*args, _cuda.stream_ptr(dev))
    else:
        threads, defer, stage = variant
        code = lib.dxv_raystab_mt_variant(*args, int(threads), int(defer),
                                          int(stage), _cuda.stream_ptr(dev))
    _cuda.check(code, KERNEL.name)
    KERNEL.launches += 1
    return t, i


def closest_hit(tb: MTTables, variant: tuple[int, bool, bool] | None = None):
    """Run the closest-hit kernel -> (t [V], id [V] int32). A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel. ``variant`` =
    (threads per block, deferred division, rows staged through shared
    memory) picks settings other than the main path's (csrc/raystab_mt.cu;
    the timing sweep)."""
    if tb.pos.device.type == "cpu":
        return closest_hit_plain(tb)
    return _launch(tb, variant)
