"""Multi-device frames: each rank's share of the work, and one all_gather.

Port of ``dxrvoxelizer_tpu/parallel/shard.py``. The JAX package runs a frame
as one ``shard_map`` program over a 1-D device mesh; here every device is a
rank of a process group (parallel/mesh.py) and a frame is a
:class:`ShardedFrame`, the same program in four steps:

- **voxelize**: each rank computes its share of the occupancy grid (an
  x-slab for the reference frame, a contiguous tile group for the production
  frame: the queue build restricted to the group's tiles and kernel 2.2 on
  them) from the replicated triangles;
- **grid exchange**: ONE ``all_gather`` of the pieces, the only collective
  of the frame;
- **render**: each rank renders its horizontal band of screen rows from the
  gathered grid (the light field and, for shear-warp, the march over the
  small intermediate are replicated; the screen resolve, kernel 2.4, and the
  gather march take the band's first row).

The rank bodies are plain functions of the rank; the collective is a step
of its own, so a :func:`~dxrvoxelizer_tpu_torch.parallel.mesh.make_local_group`
runs every rank's body in one process and concatenates the pieces exactly as
the all_gather does (the tests' and ``chip_smoke.py``'s harness).
"""

from __future__ import annotations

import numpy as np
import torch

from dxrvoxelizer_tpu_torch.ops import grid_cuda
from dxrvoxelizer_tpu_torch.ops.packing import pack_bits_z
from dxrvoxelizer_tpu_torch.ops.raymarch_fast import (
    precompute_light_volume,
    raymarch_fast,
)
from dxrvoxelizer_tpu_torch.ops.voxelize_ref import voxelize_parity_ref
from dxrvoxelizer_tpu_torch.parallel.mesh import (
    DeviceGroup,
    make_device_mesh,
    make_local_group,
)


def split(total: int, world: int, rank: int) -> tuple[int, int]:
    """Rank ``rank``'s contiguous share ``[lo, hi)`` of ``total`` items, as
    even as can be (the first ``total % world`` ranks take one more)."""
    base, extra = divmod(total, world)
    lo = rank * base + min(rank, extra)
    return lo, lo + base + (1 if rank < extra else 0)


def split_sizes(total: int, world: int) -> list[int]:
    """Every rank's share of ``total`` items (:func:`split`)."""
    return [hi - lo for lo, hi in (split(total, world, r) for r in range(world))]


class ShardedFrame:
    """A frame (or a voxelize) split across the ranks of ``group``.

    ``prepare(*args) -> ctx`` runs on every rank (replicated work such as a
    deforming accel's refit; default: ``ctx = args``); ``piece(rank, ctx)``
    is the rank's share, ``sizes(ctx)`` every rank's row count of it;
    ``assemble(gathered, ctx)`` turns the pieces, concatenated in rank order
    by the one all_gather, into what every rank holds; ``band(rank, grid,
    ctx)`` is the rank's rows of the image (None: the assembled grid is the
    result). Calling the frame runs this rank's steps and returns its band;
    on a local group it runs every rank in turn and returns the whole
    image."""

    def __init__(self, group: DeviceGroup, piece, sizes, assemble, band=None,
                 prepare=None):
        self.group = group
        self.piece = piece
        self.sizes = sizes
        self.assemble = assemble
        self.band = band
        self.prepare = prepare

    def __call__(self, *args):
        ctx = args if self.prepare is None else self.prepare(*args)
        g = self.group
        if g.local:
            gathered = torch.cat([self.piece(r, ctx) for r in range(g.world)])
        else:
            gathered = g.all_gather(self.piece(g.rank, ctx), self.sizes(ctx))
        grid = self.assemble(gathered, ctx)
        if self.band is None:
            return grid
        if g.local:
            return torch.cat([self.band(r, grid, ctx) for r in range(g.world)])
        return self.band(g.rank, grid, ctx)


def _rows(height: int, world: int) -> int:
    if height % world:
        raise ValueError(f"height {height} not divisible by {world} ranks")
    return height // world


def sharded_frame(group: DeviceGroup, n: int, width: int, height: int,
                  n_samples: int = 64, n_light: int = 16) -> ShardedFrame:
    """The reference multi-device frame: x-slab oracle voxelize + gather
    band render.

    Returns ``frame(verts_norm, tris, s2l, eye, light, clear) -> image``
    (the rank's band of ``height // world`` rows; the whole image on a local
    group). Each rank counts its ``n // world`` grid-x rows with the parity
    oracle and packs them; the gathered words are the grid."""
    world = group.world
    if n % world:
        raise ValueError(f"grid {n} not divisible by {world} ranks")
    slab, band = n // world, _rows(height, world)

    def piece(rank, ctx):
        verts, tris = ctx[0], ctx[1]
        return pack_bits_z(voxelize_parity_ref(verts, tris, n=n, x_slab=slab,
                                               x_offset=rank * slab))

    def render(rank, words, ctx):
        s2l, eye, light, clear = ctx[2:]
        density = grid_cuda.unpack_density(words, n)  # X.7
        lv = precompute_light_volume(density, light, n_light=n_light)
        return raymarch_fast(density, lv, s2l, eye, clear, width, band,
                             n_samples=n_samples, y_offset=float(rank * band))

    return ShardedFrame(group, piece, lambda ctx: [slab] * world,
                        lambda words, ctx: words, render)


def _light_mode(light_local, n: int) -> tuple[int, bool, str]:
    """Host statics for a POINT light field: (axis, flip, mode), the
    decision of ops/raymarch_warp.light_sweep_point_host: the perspective
    slab sweep ("persp") needs the light outside the volume along its major
    axis; otherwise the exact per-voxel march ("exact")."""
    from dxrvoxelizer_tpu_torch.ops.raymarch_warp import point_light_statics

    axis, flip, sweep = point_light_statics(light_local, n)
    return axis, flip, "persp" if sweep else "exact"


def light_volume_from_statics(density, light, n: int, l_axis: int,
                              l_flip: bool, l_mode: str, n_light: int = 32,
                              l_d0: int = 0) -> torch.Tensor:
    """The light field by the host-derived mode (:func:`frame_statics`):
    "persp" (X.5) and "exact" (point light), "ref" (X.3) and "exact-dir"
    (``-hq``), or the per-slab directional recurrence ("dir", X.4); a CUDA
    tensor launches the mode's kernel."""
    from dxrvoxelizer_tpu_torch.ops import raymarch_warp as rw

    if l_mode == "persp":
        return rw.light_sweep_point(density, light, n, l_axis, l_flip)
    if l_mode == "exact":
        return precompute_light_volume(density, light, n_light=n_light,
                                       point_light=True)
    if l_mode == "ref":
        return rw.light_sweep_ref(density, light, n, l_axis, l_flip, l_d0,
                                  n_light=n_light)
    if l_mode == "exact-dir":
        # -hq on a grid too small for the slab recurrence (d0 < 1):
        # light_sweep_ref_host's own fallback
        return precompute_light_volume(density, light, n_light=n_light)
    return rw.light_sweep(density, light, n, l_axis, l_flip)


def frame_statics(consts, width: int, height: int, m_cap: int = 128,
                  point_light: bool = False, grid_size: int | None = None,
                  render_ss: int = 1) -> tuple:
    """Host statics of the shear-warp band render: ``(warp axis, flip,
    swap, intermediate m, light axis, light flip, light mode, render ss,
    light d0)``, hashable (the pipeline caches frames by them and rebuilds
    when an orbiting camera crosses a major-axis boundary). The light mode
    is "dir" | "persp" | "exact" | "ref" | "exact-dir", chosen as
    core.pipeline.render chooses the light field. The JAX package's
    resolver window (a TPU block size) is not carried over."""
    from dxrvoxelizer_tpu_torch.ops import raymarch_warp as rw

    waxis, wflip, wswap, m = rw.shearwarp_statics(
        np.asarray(consts.screen_to_local, np.float32),
        np.asarray(consts.local_space_eye_pt, np.float32), width, height,
        m_cap=m_cap)
    l_d0 = 0
    if point_light:
        if grid_size is None:
            raise ValueError("point-light statics need grid_size")
        l_axis, l_flip, l_mode = _light_mode(consts.local_space_light_pt,
                                             grid_size)
    elif render_ss > 1:
        if grid_size is None:
            raise ValueError("-hq statics need grid_size")
        l_axis, l_flip, l_d0 = rw.light_ref_statics(
            consts.local_space_light_pt, grid_size)
        if l_d0 >= 1:
            l_mode = "ref"
        else:  # tiny grid: light_sweep_ref_host's exact fallback
            l_axis, l_flip = rw.light_statics(consts.local_space_light_pt)
            l_mode, l_d0 = "exact-dir", 0
    else:
        l_axis, l_flip = rw.light_statics(consts.local_space_light_pt)
        l_mode = "dir"
    return (waxis, wflip, wswap, m, l_axis, l_flip, l_mode, int(render_ss),
            l_d0)


def _n_tiles(n: int) -> int:
    from dxrvoxelizer_tpu_torch.ops.voxelize_queue_cuda import TILE_X, TILE_Y

    return (n // TILE_X) * (n // TILE_Y)


def queue_group_piece(verts_norm, tris, n: int, num_chunks_cap: int,
                      world: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s tile group of the parity words, [tiles, N//32, 128]:
    the device queue build restricted to the group's tiles (no host sync)
    and kernel 2.2 on them (its plain version on the CPU)."""
    from dxrvoxelizer_tpu_torch.ops.voxelize_queue import (
        SPAN_CAP,
        _build_queue_device,
    )
    from dxrvoxelizer_tpu_torch.ops.voxelize_queue_cuda import (
        voxelize_parity_queue_chunks,
    )

    lo, hi = split(_n_tiles(n), world, rank)
    coefs, spans, tile_of, nsub, _, _ = _build_queue_device(
        verts_norm, tris, n, num_chunks_cap, *SPAN_CAP, tile_lo=lo,
        tile_hi=hi)
    return voxelize_parity_queue_chunks(coefs, tile_of, nsub, n, spans=spans,
                                        tile_lo=lo, tiles=hi - lo)


def _tiles_to_words(tiles_all: torch.Tensor, n: int) -> torch.Tensor:
    from dxrvoxelizer_tpu_torch.ops.voxelize_queue_cuda import _tiles_to_grid

    return _tiles_to_grid(tiles_all, n).contiguous()


def sharded_frame_fast(
    group: DeviceGroup,
    n: int,
    width: int,
    height: int,
    tris_count: int,
    sample_consts=None,
    num_chunks_cap: int = 512,
    statics: tuple | None = None,
    render_impl: str = "warp",
    n_samples: int = 128,
    n_light: int = 32,
    point_light: bool = False,
) -> ShardedFrame:
    """The production multi-device frame.

    - voxelize: each rank builds the device queue of its contiguous tile
      group and runs kernel 2.2 on it (:func:`queue_group_piece`);
    - grid exchange: ONE all_gather of the groups' words (2 MiB at 256^3);
    - render: each rank's band, shear-warp ("warp": the orientation
      ``statics`` of :func:`frame_statics`, or derived from
      ``sample_consts``) or the gather march ("gather").

    Returns ``frame(verts_norm, tris, s2l, eye, light, clear) -> image``.
    ``tris_count`` is the mesh's triangle count (the JAX package's
    signature; the queue build reads it from ``tris``). Tile groups may
    differ by one tile; the height must divide by the world size."""
    from dxrvoxelizer_tpu_torch.parallel.raystab_shard import (
        _make_band_renderer,
    )

    del tris_count
    world = group.world
    if render_impl == "warp" and statics is None:
        if sample_consts is None:
            raise ValueError("the warp band render needs sample_consts or "
                             "statics")
        statics = frame_statics(sample_consts, width, height,
                                point_light=point_light, grid_size=n)
    render = _make_band_renderer(world, n, width, height, statics, render_impl,
                                 n_samples, n_light, point_light)

    def piece(rank, ctx):
        return queue_group_piece(ctx[0], ctx[1], n, num_chunks_cap, world,
                                 rank)

    def assemble(tiles_all, ctx):
        return grid_cuda.unpack_density(_tiles_to_words(tiles_all, n), n)

    return ShardedFrame(
        group, piece, lambda ctx: split_sizes(_n_tiles(n), world), assemble,
        lambda rank, density, ctx: render(rank, density, *ctx[2:]))


def sharded_voxelize(group: DeviceGroup, n: int,
                     num_chunks_cap: int) -> ShardedFrame:
    """Collective multi-device parity voxelize -> ``vox(verts_norm, tris)
    -> packed words [N, N, N//32]`` on every rank: each rank's tile group
    (:func:`queue_group_piece`, no host sync, so deforming meshes re-bin
    every frame) and one all_gather of the groups' words. Bit-identical to
    the single-device queue kernel.

    ``num_chunks_cap`` is the per-group queue capacity: a group whose queue
    needs more is truncated, so size it from the rest mesh with
    :func:`queue_capacity`."""
    world = group.world
    return ShardedFrame(
        group,
        lambda rank, ctx: queue_group_piece(ctx[0], ctx[1], n, num_chunks_cap,
                                            world, rank),
        lambda ctx: split_sizes(_n_tiles(n), world),
        lambda tiles_all, ctx: _tiles_to_words(tiles_all, n))


def queue_capacity(verts_norm, tris, n: int, n_groups: int,
                   headroom: float = 1.5) -> int:
    """Per-group queue chunk capacity sized from a rest mesh: the densest
    group's chunk count x ``headroom`` (deformation moves triangles between
    groups, so the headroom absorbs cross-group drift too) + 8, rounded up
    to 128 (the DeformingVoxelizer's rule)."""
    from dxrvoxelizer_tpu_torch.ops.voxelize_queue import build_queue

    _, _, ctile, _, _, stats = build_queue(verts_norm, tris, n)
    if n_groups == 1:
        cap = int(stats.real_chunks * headroom) + 8
    else:
        ct_h = ctile[: stats.real_chunks].cpu().numpy()
        his = np.cumsum(split_sizes(_n_tiles(n), n_groups))
        per_group = np.bincount(np.searchsorted(his, ct_h, side="right"),
                                minlength=n_groups)
        cap = int(per_group.max() * headroom) + 8
    return -(-cap // 128) * 128


def voxelize_parity_multichip(verts_norm, tris, n: int,
                              group: DeviceGroup | None = None) -> torch.Tensor:
    """Stateless multi-device parity voxelize -> packed words [N, N, N//32].

    A convenience over :func:`sharded_voxelize` (one extra host-synced
    queue build sizes the capacity). ``group``: the process group's ranks
    when one is initialised, else a local group of one rank on the
    vertices' device."""
    import torch.distributed as dist

    if group is None:
        group = (make_device_mesh() if dist.is_initialized()
                 else make_local_group(1, verts_norm.device))
    cap = queue_capacity(verts_norm, tris, n, group.world)
    return sharded_voxelize(group, n, cap)(verts_norm, tris)
