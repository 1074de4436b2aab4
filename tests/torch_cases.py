"""Synthetic strip tables that stress the ray-stab fold kernel
(csrc/raystab_fold.cu) at its boundaries, built from a real gen-6 accel; and
the settings of the redesigned kernels' timing sweeps.

Shared by ``tests/test_torch_cuda.py``, ``tests/test_torch_raystab.py`` (the
plain fold, on the CPU) and ``chip_smoke.py`` (which loads this file by
path). numpy and the port only.
"""

from __future__ import annotations

import importlib.util
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from dxrvoxelizer_tpu_torch.ops import raystab_cuda as rsc
from dxrvoxelizer_tpu_torch.ops import raystab_fast as rsf

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


def chunks_run(tb: rsc.StripTables, strip: int) -> list[bool]:
    """Which chunks of ``strip`` the fold tests: a chunk runs unless every
    lane's best t over the chunks before it is below its bound (replayed
    with the plain fold)."""
    import dataclasses

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
