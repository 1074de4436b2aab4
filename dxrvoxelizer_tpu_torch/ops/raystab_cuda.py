"""Ray-stab closest hit over strips of 128 radial rays: the CUDA kernel and its
plain version.

Port of the fused fold + extraction kernels of
``dxrvoxelizer_tpu/ops/raystab_pallas.py`` (``_fold_extract_kernel6`` and
``_fold_extract_kernel2``, one computation on the TPU's two table layouts)
and of the fold alone (``_stab_kernel2``). A strip is 128 ray lanes (rows
dx dy dz s0; an all-zero lane is padding) tested against its candidate
rows, ``rows[cand_off[s] : cand_off[s] + cand_cnt[s]]``, each a fused
24-float row ``g0 g1 g2 c id pad | n0 n1 n2 pad(3)`` (ops/raystab_fast.py).
A refitted stream holds no rows of its own: its candidate ``p`` is row
``row_ids[p]`` of the per-triangle table, which the kernel reads through
the id.
Per lane: ``intersect.radial_hit`` against every candidate, the
lexicographic (t, lowest id) minimum, the winner's 9 coefficient and 9
normal floats, and the finished (nx, ny, nz, a) channels. Candidates come in
chunks of 256; ``bounds[s, j]`` is a strict lower bound on t of any hit in
chunk j, and a chunk is skipped once every lane's best t is below it.

- :func:`fold_extract` / :func:`fold` are the wrappers: a CUDA tensor
  launches ``csrc/raystab_fold.cu`` (fold + extraction + finalize, or the
  fold alone), a CPU tensor takes the plain version.
- :func:`fold_extract_plain` / :func:`fold_plain` are the plain torch
  versions: every strip batch and chunk at once, the chunk's minimum by
  ``min`` reductions, the winner's rows by a gather.

Outputs per slot: t [S,128] f32 (+inf on a miss, -inf on a padding lane),
id [S,128] int32 (2^30 on a miss) and ns [S,128,4] f32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from dxrvoxelizer_tpu_torch.ops import _cuda, intersect

LANES = 128  # rays per strip
K_BLOCK = 256  # candidates per chunk (the skip bounds' unit)
NROW = 24  # floats per candidate row: g0 g1 g2 c id pad | n0 n1 n2 pad(3)
C_COL, ID_COL, N_COL = 9, 10, 12
PLAIN_BATCH = 128  # strips per step of the plain version (bounds its memory)

FOLD_EXTRACT = _cuda.Kernel(
    name="raystab_fold_extract",
    symbol="stab_kernel<true,",  # <true, groups, stages, defer>
    source="dxrvoxelizer_tpu_torch/csrc/raystab_fold.cu",
    replaces="dxrvoxelizer_tpu/ops/raystab_pallas.py:603",
)
FOLD = _cuda.Kernel(
    name="raystab_fold",
    symbol="stab_kernel<false,",
    source="dxrvoxelizer_tpu_torch/csrc/raystab_fold.cu",
    replaces="dxrvoxelizer_tpu/ops/raystab_pallas.py:185",
)


@dataclass
class StripTables:
    """One strip stream: ``rays`` [S,4,128] f32, ``cand_off`` and
    ``cand_cnt`` [S] int32, ``rows`` [P,24] f32, ``bounds`` [S,B] f32 chunk
    lower bounds on t (-inf: no bound) or None.

    ``row_ids`` [P] int32 or None: when set, ``rows`` is the per-triangle
    table [T+1,24] and candidate ``p`` of the stream is ``rows[row_ids[p]]``
    (a refitted stream: its rows are never materialised). The ids must lie
    in ``[0, rows.shape[0])``: the plain version raises on one outside, the
    kernel traps before it reads through it (a CUDA error, as torch's own
    gathers give). Checking them on the host would cost a sync, so the
    owner of the ids checks them once (``RaystabRefitter``)."""

    rays: torch.Tensor
    cand_off: torch.Tensor
    cand_cnt: torch.Tensor
    rows: torch.Tensor
    bounds: torch.Tensor | None = None
    row_ids: torch.Tensor | None = None

    @property
    def strips(self) -> int:
        return int(self.rays.shape[0])


def candidate_rows(tb: StripTables) -> torch.Tensor:
    """The stream's candidate rows [P,24]: ``rows``, or gathered through
    ``row_ids`` (a copy; the plain versions and the tests take it)."""
    return tb.rows if tb.row_ids is None else tb.rows.index_select(0, tb.row_ids)


def strip_slice(tb: StripTables, lo: int, hi: int) -> StripTables:
    """Strips ``[lo, hi)`` of a stream (views; the candidate rows, or the
    table and its ids, are shared): the kernel's output for them equals
    those strips of the whole stream's, bit for bit (each strip is folded on
    its own)."""
    return StripTables(
        rays=tb.rays[lo:hi], cand_off=tb.cand_off[lo:hi],
        cand_cnt=tb.cand_cnt[lo:hi], rows=tb.rows,
        bounds=None if tb.bounds is None else tb.bounds[lo:hi],
        row_ids=tb.row_ids)


def _check(tb: StripTables, t_count: int) -> None:
    s = tb.strips
    if tb.rays.ndim != 3 or tuple(tb.rays.shape[1:]) != (4, LANES):
        raise ValueError(f"rays: expected [S, 4, {LANES}], got {tuple(tb.rays.shape)}")
    if tb.rows.ndim != 2 or tb.rows.shape[1] != NROW:
        raise ValueError(f"rows: expected [P, {NROW}], got {tuple(tb.rows.shape)}")
    if tb.row_ids is not None and (tb.row_ids.ndim != 1
                                   or tb.row_ids.dtype != torch.int32):
        raise ValueError(f"row_ids: expected [P] int32, got "
                         f"{tuple(tb.row_ids.shape)} {tb.row_ids.dtype}")
    if tb.row_ids is not None and tb.row_ids.numel() and tb.rows.shape[0] == 0:
        raise ValueError("rows: row ids into an empty table")
    for name, x in (("cand_off", tb.cand_off), ("cand_cnt", tb.cand_cnt)):
        if tuple(x.shape) != (s,):
            raise ValueError(f"{name}: expected [{s}], got {tuple(x.shape)}")
    if tb.bounds is not None and (tb.bounds.ndim != 2 or tb.bounds.shape[0] != s):
        raise ValueError(f"bounds: expected [{s}, B], got {tuple(tb.bounds.shape)}")
    if not 0 <= t_count < 2**24:
        raise ValueError(f"t_count {t_count} outside the f32 id range [0, 2^24)")


def _plain(tb: StripTables, t_count: int, threshold: float, rule: str,
           extract: bool):
    _check(tb, t_count)
    dev = tb.rays.device
    s_all = tb.strips
    inf = float("inf")
    big = float(intersect.BIG_ID)
    rows = candidate_rows(tb)
    p = rows.shape[0]
    pad_row = torch.zeros((1, NROW), dtype=torch.float32, device=dev)
    pad_row[0, ID_COL] = big  # what a missing candidate tests as: a miss
    rows_p = torch.cat([rows, pad_row])
    n_bnd = 0 if tb.bounds is None else tb.bounds.shape[1]
    t_out = torch.empty((s_all, LANES), dtype=torch.float32, device=dev)
    i_out = torch.empty((s_all, LANES), dtype=torch.int32, device=dev)
    ns_out = torch.zeros((s_all, LANES, 4), dtype=torch.float32, device=dev)
    k_loc = torch.arange(K_BLOCK, device=dev)
    for b0 in range(0, s_all, PLAIN_BATCH):
        sl = slice(b0, b0 + PLAIN_BATCH)
        ray = tb.rays[sl]
        dx, dy, dz, s0 = (ray[:, r, :, None] for r in range(4))  # [B,128,1]
        pad = (dx == 0.0) & (dy == 0.0) & (dz == 0.0)
        bt = torch.where(pad, -inf, inf)[..., 0]  # [B,128]
        bi = torch.full_like(bt, big)
        win = torch.zeros(bt.shape + (18,), dtype=torch.float32, device=dev)
        off = tb.cand_off[sl].to(torch.int64)
        cnt = tb.cand_cnt[sl].to(torch.int64)
        n_chunks = -(-int(cnt.max()) // K_BLOCK) if cnt.numel() else 0
        for j in range(n_chunks):
            k = k_loc + j * K_BLOCK
            idx = torch.where(k[None, :] < cnt[:, None], off[:, None] + k, p)
            q = rows_p[idx]  # [B, 256, 24]
            bound = (tb.bounds[sl, j] if j < n_bnd
                     else torch.full_like(bt[:, 0], -inf))
            # skip unless some lane's best t reaches the chunk's bound
            run = (bt >= bound[:, None]).any(dim=1) & (j * K_BLOCK < cnt)

            def col(c):
                return q[:, None, :, c]  # [B,1,256]

            tt, hit = intersect.radial_hit(
                dx, dy, dz, s0, *(col(c) for c in range(9)), col(C_COL))
            ii = torch.where(hit, col(ID_COL), big)  # [B,128,256]
            t_min = tt.min(dim=-1).values
            i_min = torch.where(tt == t_min[..., None], ii, big).min(dim=-1).values
            closer = ((t_min < bt) | ((t_min == bt) & (i_min < bi))) & run[:, None]
            bt = torch.where(closer, t_min, bt)
            bi = torch.where(closer, i_min, bi)
            if extract:
                # the winner's rows: a copy, selected where it came from here
                pos = (ii == i_min[..., None]).to(torch.int8).argmax(dim=-1)
                sel = torch.gather(q, 1, pos[..., None].expand(-1, -1, NROW))
                sel = torch.cat([sel[..., 0:9], sel[..., N_COL:N_COL + 9]], -1)
                win = torch.where(closer[..., None], sel, win)
        t_out[sl] = bt
        i_out[sl] = bi.to(torch.int32)
        if extract:
            hit = torch.isfinite(bt) & (bi < float(t_count))
            g = [win[..., c] for c in range(9)]
            nv = [win[..., 9 + c] for c in range(9)]
            inside, nx, ny, nz = intersect.radial_finalize(
                dx[..., 0], dy[..., 0], dz[..., 0], g, nv, hit, threshold, rule)
            zero = torch.zeros_like(nx)
            ns_out[sl] = torch.stack(
                [torch.where(inside, nx, zero), torch.where(inside, ny, zero),
                 torch.where(inside, nz, zero),
                 torch.where(inside, torch.ones_like(nx), zero)], dim=-1)
    return t_out, i_out, ns_out


def fold_extract_plain(tb: StripTables, t_count: int, threshold: float,
                       rule: str = "backface"):
    """Plain torch version of the fold + extraction kernel ->
    (t [S,128], id [S,128] int32, ns [S,128,4])."""
    return _plain(tb, t_count, threshold, rule, extract=True)


def fold_plain(tb: StripTables):
    """Plain torch version of the fold-only kernel -> (t, id)."""
    t, i, _ = _plain(tb, 0, 0.0, "hit", extract=False)
    return t, i


def _launch(tb: StripTables, t_count: int, threshold: float, rule: str,
            extract: bool, variant: tuple | None = None):
    _check(tb, t_count)
    _cuda.require(tb.rays, "rays", torch.float32)
    _cuda.require(tb.cand_off, "cand_off", torch.int32)
    _cuda.require(tb.cand_cnt, "cand_cnt", torch.int32)
    _cuda.require(tb.rows, "rows", torch.float32)
    if tb.row_ids is not None:
        _cuda.require(tb.row_ids, "row_ids", torch.int32)
    if tb.bounds is not None:
        _cuda.require(tb.bounds, "bounds", torch.float32)
    dev = tb.rays.device
    lib = _cuda.load()
    if tb.rows.data_ptr() % 16:
        raise ValueError("rows: the kernel copies 16-byte pieces of them; "
                         "expected a 16-byte aligned tensor")
    s = tb.strips
    t = torch.empty((s, LANES), dtype=torch.float32, device=dev)
    i = torch.empty((s, LANES), dtype=torch.int32, device=dev)
    ids_ptr = 0 if tb.row_ids is None else tb.row_ids.data_ptr()
    n_rows = int(tb.rows.shape[0])
    bnd_ptr = 0 if tb.bounds is None else tb.bounds.data_ptr()
    n_bnd = 0 if tb.bounds is None else int(tb.bounds.shape[1])
    if extract:
        ns = torch.empty((s, LANES, 4), dtype=torch.float32, device=dev)
        args = (tb.rays.data_ptr(), tb.cand_off.data_ptr(),
                tb.cand_cnt.data_ptr(), tb.rows.data_ptr(), ids_ptr, n_rows,
                bnd_ptr, n_bnd, t.data_ptr(), i.data_ptr(), ns.data_ptr(), s,
                t_count, threshold, int(rule == "hit"))
        if variant is None:
            code = lib.dxv_raystab_fold_extract(*args, _cuda.stream_ptr(dev))
        else:
            groups, stages, defer = variant
            code = lib.dxv_raystab_fold_extract_variant(
                *args, int(groups), int(stages), int(defer),
                _cuda.stream_ptr(dev))
        _cuda.check(code, FOLD_EXTRACT.name)
        FOLD_EXTRACT.launches += 1
        return t, i, ns
    code = lib.dxv_raystab_fold(
        tb.rays.data_ptr(), tb.cand_off.data_ptr(), tb.cand_cnt.data_ptr(),
        tb.rows.data_ptr(), ids_ptr, n_rows, bnd_ptr, n_bnd, t.data_ptr(),
        i.data_ptr(), s, _cuda.stream_ptr(dev),
    )
    _cuda.check(code, FOLD.name)
    FOLD.launches += 1
    return t, i


def fold_extract(tb: StripTables, t_count: int, threshold: float,
                 rule: str = "backface", variant: tuple | None = None):
    """Run the fold + extraction kernel -> (t, id, ns). A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel. ``variant`` = (groups
    per strip, ring stages, deferred division) picks settings of the kernel
    other than the main path's (csrc/raystab_fold.cu; the timing sweep)."""
    if rule not in ("backface", "hit"):
        raise ValueError(f"unknown rule {rule!r}")
    if tb.rays.device.type == "cpu":
        return fold_extract_plain(tb, t_count, threshold, rule)
    return _launch(tb, t_count, threshold, rule, extract=True, variant=variant)


def fold(tb: StripTables):
    """Run the fold-only kernel -> (t, id). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel."""
    if tb.rays.device.type == "cpu":
        return fold_plain(tb)
    return _launch(tb, 0, 0.0, "hit", extract=False)
