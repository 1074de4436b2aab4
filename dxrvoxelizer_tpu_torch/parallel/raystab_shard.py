"""Multi-device ray-stab query: the DispatchRays analog split across ranks.

Port of ``dxrvoxelizer_tpu/parallel/raystab_shard.py``. Strips are
independent rows of the fold + extraction kernel (2.5/2.6,
``csrc/raystab_fold.cu``), so each rank folds a contiguous slice of every
strip stream of the accel (gen-6: the main stream and the near-origin
stream; gen-7: the live tiles), ONE all_gather brings every rank's channels
together, and the merge runs on the gathered channels on every rank: gen-7's
untiling X.6 and gen-6's stream merge X.10 (ops/grid_cuda.py, the kernels
reading the gathered pieces in place; their plain versions on CPU tensors),
which for a frame also round the grid and write its density. The slices
may differ by one strip: the JAX
package's padding of each class to a multiple of the TPU's strips per grid
step is not carried over. A strip's outputs do not depend on the other
strips, so the sharded query is bit-identical to the single-device one.

The reference app is single-GPU (SURVEY.md section 2c); this is the
scale-out of its DispatchRays(64, 64*64, 1) voxelize dispatch
(Voxelizer.cpp:367-368).
"""

from __future__ import annotations

import torch

from dxrvoxelizer_tpu_torch.ops import grid_cuda, raystab_cuda
from dxrvoxelizer_tpu_torch.ops.packing import quantize_r10g10b10a2
from dxrvoxelizer_tpu_torch.ops.raystab_fast import (
    INSIDE_THRESHOLD,
    RaystabAccel2,
    strip_streams2,
)
from dxrvoxelizer_tpu_torch.ops.raystab_tiled import RaystabAccel7
from dxrvoxelizer_tpu_torch.parallel.mesh import DeviceGroup
from dxrvoxelizer_tpu_torch.parallel.shard import (
    ShardedFrame,
    _rows,
    light_volume_from_statics,
    split,
    split_sizes,
)


def _streams(accel) -> dict:
    if isinstance(accel, RaystabAccel7):
        return {} if accel.main is None else {"main": accel.main}
    return strip_streams2(accel)


def _channels(accel) -> int:
    """Floats per lane each rank sends: gen-6 merges by (t, id) too (t, the
    id's bits, ns), gen-7 needs ns alone."""
    return 4 if isinstance(accel, RaystabAccel7) else 6


def stream_piece(accel, world: int, rank: int, threshold: float,
                 rule: str) -> torch.Tensor:
    """Rank ``rank``'s fold + extraction over its slice of every strip
    stream -> [strips, 128, C] f32 (:func:`_channels`), the streams' slices
    one after another."""
    c = _channels(accel)
    parts = []
    for tb in _streams(accel).values():
        lo, hi = split(tb.strips, world, rank)
        if hi == lo:
            continue
        t, i, ns = raystab_cuda.fold_extract(
            raystab_cuda.strip_slice(tb, lo, hi), accel.t_count, threshold,
            rule)
        parts.append(ns if c == 4 else torch.cat(
            [t[..., None], i.view(torch.float32)[..., None], ns], dim=-1))
    if not parts:
        return torch.zeros((0, raystab_cuda.LANES, c), dtype=torch.float32,
                           device=accel.device)
    return torch.cat(parts)


def stream_sizes(accel, world: int) -> list[int]:
    """Every rank's strip count in :func:`stream_piece`."""
    per = [split_sizes(tb.strips, world) for tb in _streams(accel).values()]
    return [sum(p[r] for p in per) for r in range(world)]


def merge_pieces(accel, gathered: torch.Tensor, world: int,
                 grid: bool = False):
    """The gathered pieces (rank order; each rank's streams in turn) ->
    the single-device query's (occupancy [n,n,n] bool, rgba [n,n,n,4] f32),
    or with ``grid`` the frame's grid (rgba rounded through R10G10B10A2,
    None for the words, density [n,n,n] or None): gen-7's untiling X.6 or
    gen-6's merge X.10 (``grid_cuda.untile`` / ``grid_cuda.merge``; the
    plain versions on CPU tensors, where the density is None)."""
    streams = _streams(accel)
    if len(streams) == 1:  # the ranks' slices of one stream, in order
        outs = dict.fromkeys(streams, gathered)
    else:
        parts = {k: [] for k in streams}
        row = 0
        for r in range(world):
            for k, tb in streams.items():
                lo, hi = split(tb.strips, world, r)
                parts[k].append(gathered[row:row + hi - lo])
                row += hi - lo
        outs = {k: v[0] if len(v) == 1 else torch.cat(v)
                for k, v in parts.items()}
    kw = (dict(words=False) if grid
          else dict(quantize=False, words=False, density=False))
    if isinstance(accel, RaystabAccel7):
        out = grid_cuda.untile(outs.get("main"), accel.n,
                               tiles=(accel.tids, accel.slots), **kw)
    else:
        # t, the id's bits and the channels, read in place
        out = grid_cuda.merge(accel, {
            k: (g[..., 0], g[..., 1].view(torch.int32), g[..., 2:])
            for k, g in outs.items()}, **kw)
    if grid:
        return out
    return out[0][..., 3] != 0.0, out[0]


def _query_frame(group: DeviceGroup, accel_of, threshold: float, rule: str,
                 band=None, prepare=None) -> ShardedFrame:
    """A :class:`ShardedFrame` over the accel ``accel_of(ctx)``: pieces by
    :func:`stream_piece`, assembled by :func:`merge_pieces` (into the
    frame's grid when there is a ``band``)."""
    world = group.world
    return ShardedFrame(
        group,
        lambda rank, ctx: stream_piece(accel_of(ctx), world, rank, threshold,
                                       rule),
        lambda ctx: stream_sizes(accel_of(ctx), world),
        lambda gathered, ctx: merge_pieces(accel_of(ctx), gathered, world,
                                           grid=band is not None),
        band=band, prepare=prepare)


def raystab_query7_sharded(verts_norm, normals, tris, accel: RaystabAccel7,
                           group: DeviceGroup,
                           threshold: float = INSIDE_THRESHOLD,
                           rule: str = "backface"):
    """Multi-device gen-7 trace -> (occupancy, rgba) on every rank,
    bit-identical to :func:`~dxrvoxelizer_tpu_torch.ops.raystab_tiled.
    raystab_query7`. The geometry arguments are baked into the accel."""
    del verts_norm, normals, tris
    return _query_frame(group, lambda ctx: accel, threshold, rule)()


def raystab_query2_sharded(verts_norm, normals, tris, accel: RaystabAccel2,
                           group: DeviceGroup,
                           threshold: float = INSIDE_THRESHOLD,
                           rule: str = "backface"):
    """Multi-device gen-6 trace -> (occupancy, rgba) on every rank,
    bit-identical to :func:`~dxrvoxelizer_tpu_torch.ops.raystab_fast.
    raystab_query2`. The geometry arguments must be what the accel was
    built from (the DXR contract); they are baked into it."""
    del verts_norm, normals, tris
    return _query_frame(group, lambda ctx: accel, threshold, rule)()


def _make_band_renderer(world: int, n: int, width: int, height: int,
                        statics: tuple | None, render_impl: str,
                        n_samples: int, n_light: int, point_light: bool):
    """The band renderer the sharded frames share: ``render(rank, density,
    s2l, eye, light, clear) -> [height // world, width, 3]``, the rank's
    horizontal band of the image from the replicated density, by shear-warp
    ("warp"; the light field and the march replicated, kernel 2.4 on the
    band's rows; orientation ``statics`` from ``shard.frame_statics``) or the
    gather march ("gather"; the light volume replicated, the march kernel on
    the band's rows; statics-free)."""
    band = _rows(height, world)
    if render_impl == "warp":
        from dxrvoxelizer_tpu_torch.ops import raymarch_warp as rw

        if statics is None:
            raise ValueError("the warp band render needs its statics")
        (waxis, wflip, wswap, m, l_axis, l_flip, l_mode, ss, l_d0) = statics

        def render(rank, density, s2l, eye, light, clear):
            lv = light_volume_from_statics(density, light, n, l_axis, l_flip,
                                           l_mode, n_light=n_light, l_d0=l_d0)
            return rw._shearwarp_core(density, lv, s2l, eye, clear, n, m,
                                      width, band, waxis, wflip, wswap, ss=ss,
                                      y_off=rank * band)
    elif render_impl == "gather":
        from dxrvoxelizer_tpu_torch.ops.raymarch_fast import (
            precompute_light_volume,
            raymarch_fast,
        )

        def render(rank, density, s2l, eye, light, clear):
            lv = precompute_light_volume(density, light, n_light=n_light,
                                         point_light=point_light)
            return raymarch_fast(density, lv, s2l, eye, clear, width, band,
                                 n_samples=n_samples,
                                 y_offset=float(rank * band))
    else:
        raise ValueError(f"unknown sharded render impl {render_impl!r}")
    return render


def _stab_density(rgba: torch.Tensor) -> torch.Tensor:
    """The frame's density from the unrounded winner rgba: quantized
    through R10G10B10A2 (the reference grid format), its alpha. The plain
    chain that :func:`_grid_density` replaces (the tests hold the frames
    against it)."""
    return quantize_r10g10b10a2(rgba)[..., 3].contiguous()


def _grid_density(grid) -> torch.Tensor:
    """The frame's density from :func:`merge_pieces`' grid: the rounded
    alpha the kernel wrote, or the plain version's ``rgba[..., 3]``."""
    rgba, _, dens = grid
    return rgba[..., 3].contiguous() if dens is None else dens


def sharded_frame_raystab(
    group: DeviceGroup,
    accel,
    t_count: int,
    n: int,
    width: int,
    height: int,
    statics: tuple | None,
    threshold: float = INSIDE_THRESHOLD,
    render_impl: str = "warp",
    n_samples: int = 128,
    n_light: int = 32,
    point_light: bool = False,
) -> ShardedFrame:
    """Multi-device ray-stab frame: the strip-sliced query + band render.

    Returns ``frame(verts_norm, tris, s2l, eye, light, clear) -> image``
    (the signature of ``shard.sharded_frame_fast``; the geometry is baked
    into ``accel``, a gen-6 ``RaystabAccel2`` or gen-7 ``RaystabAccel7``,
    like the reference's init-built AS, Voxelizer.cpp:264-326). Per frame
    every voxel ray is traced again, the winner rgba quantized, and each
    rank renders its band (``render_impl`` "warp" with ``statics``, or
    "gather"). ``t_count``: the mesh's triangle count (the accel's)."""
    if t_count != accel.t_count:
        raise ValueError(f"t_count {t_count} is not the accel's "
                         f"{accel.t_count}")
    render = _make_band_renderer(group.world, n, width, height, statics,
                                 render_impl, n_samples, n_light, point_light)
    return _query_frame(
        group, lambda ctx: accel, threshold, "backface",
        band=lambda rank, grid, ctx: render(rank, _grid_density(grid),
                                            *ctx[2:]))


def sharded_frame_raystab_deforming(
    group: DeviceGroup,
    refitter,
    n: int,
    width: int,
    height: int,
    statics: tuple | None,
    threshold: float = INSIDE_THRESHOLD,
    render_impl: str = "warp",
    n_samples: int = 128,
    n_light: int = 32,
    point_light: bool = False,
) -> ShardedFrame:
    """Multi-device DEFORMING ray-stab frame: the per-frame refit, then the
    strip-sliced query and the band render of :func:`sharded_frame_raystab`.

    ``refitter``: an ``ops.raystab_refit.RaystabRefitter`` (gen-6) or
    ``ops.raystab_tiled.RaystabTiledRefitter`` (gen-7) built from the rest
    mesh. Returns ``frame(verts_norm, normals, s2l, eye, light, clear) ->
    image``: NORMALS in the second slot where the static frame takes
    ``tris`` (the refit regathers the normal rows each frame). The refit
    (one row gather) runs on every rank; no contract check here (the
    pipeline checks the first frame)."""
    render = _make_band_renderer(group.world, n, width, height, statics,
                                 render_impl, n_samples, n_light, point_light)

    def prepare(verts_norm, normals, *rest):
        return (refitter.refit(verts_norm, normals), None, *rest)

    return _query_frame(
        group, lambda ctx: ctx[0], threshold, "backface",
        band=lambda rank, grid, ctx: render(rank, _grid_density(grid),
                                            *ctx[2:]),
        prepare=prepare)
