"""Ray-stab Moller-Trumbore closest hit over per-cell candidate lists: the
CUDA kernel and its plain version (the gen-1 accel's query).

Port of ``_stab_kernel`` in ``dxrvoxelizer_tpu/ops/raystab_pallas.py``
(launched by ``stab_closest_hit``). A stream of slices covers every voxel
ray once: slice s holds at most 128 rays, ``ray_ids[ray_off[s] :
ray_off[s] + ray_cnt[s]]``, and tests them against its candidate rows
``rows[cand_off[s] : cand_off[s] + cand_cnt[s]]``, each 12 floats
``v0 e1 e2 id pad pad`` (ops/raystab_fast.py). Per ray: ``intersect.mt_hit``
against every candidate and the lexicographic (t, lowest id) minimum over
the hits. The overflow stream is the same layout: strips of all rays in
voxel order (``ray_ids`` = 0..V-1), every strip against all the overflow
rows.

- :func:`closest_hit` is the wrapper: a CUDA tensor launches
  ``csrc/raystab_mt.cu``, a CPU tensor takes the plain version.
- :func:`closest_hit_plain` is the plain torch version, the JAX package's
  gather form of ``_query_cells`` (every batch of slices at once, the
  minimum by ``min`` reductions); on the overflow stream it gives
  ``_overflow_pass``'s (t, id), in any row order.

Outputs per ray, in voxel order: t [V] f32 (+inf on a miss) and id [V]
int32 (2^30 on a miss); t is the winner's own value.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from dxrvoxelizer_tpu_torch.ops import _cuda, intersect

LANES = 128  # rays per slice
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
    [P,12] f32. The slices must cover every ray once."""

    pos: torch.Tensor
    dirs: torch.Tensor
    ray_ids: torch.Tensor
    ray_off: torch.Tensor
    ray_cnt: torch.Tensor
    cand_off: torch.Tensor
    cand_cnt: torch.Tensor
    rows: torch.Tensor

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
    step = max(1, PLAIN_PAIRS // (LANES * widest))
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


def _launch(tb: MTTables):
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
    code = lib.dxv_raystab_mt(
        tb.pos.data_ptr(), tb.dirs.data_ptr(), tb.ray_ids.data_ptr(),
        tb.ray_off.data_ptr(), tb.ray_cnt.data_ptr(), tb.cand_off.data_ptr(),
        tb.cand_cnt.data_ptr(), tb.rows.data_ptr(), t.data_ptr(), i.data_ptr(),
        tb.slices, _cuda.stream_ptr(dev),
    )
    _cuda.check(code, KERNEL.name)
    KERNEL.launches += 1
    return t, i


def closest_hit(tb: MTTables):
    """Run the closest-hit kernel -> (t [V], id [V] int32). A CPU tensor takes
    the plain version; a CUDA tensor launches the kernel."""
    if tb.pos.device.type == "cpu":
        return closest_hit_plain(tb)
    return _launch(tb)
