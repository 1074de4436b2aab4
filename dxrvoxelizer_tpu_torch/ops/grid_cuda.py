"""The frame's grid glue as hand-written kernels (``csrc/grid.cu``).

Three XLA functions of the JAX package that XLA fuses under ``jit`` and
that the port ran as chains of eager torch ops, each writing a full-grid
intermediate:

- X.6 :func:`untile`: the gen-7 query's untiling
  (``dxrvoxelizer_tpu/ops/raystab_tiled.py:521-531``) with the
  R10G10B10A2 rounding and the word packing of its output
  (``ops/packing.py:40-70``, called at ``core/pipeline.py:128``) -> the
  grid's rgba, words and density in one pass, and in a second form of the
  same body the words-gated normal channel of ``-normals``
  (``_parity_rgba``). Its input already in grid order (gen-6's merged
  streams, the JAX CPU frame's oracle) takes the plain version only: on
  the card X.10 reads gen-6's streams themselves.
- X.7 :func:`unpack_density`: ``VoxelGrid.density`` of a parity grid
  (``core/pipeline.py:57-64``).
- X.8 :func:`slabs`: the march's ``[2, K, X, Y]`` slab stack
  (``ops/raymarch_warp.py:461-465``).
- X.10 :func:`merge`: gen-6's stream merge
  (``dxrvoxelizer_tpu/ops/raystab_fast.py:1956 _merge_winners2``; the
  port's ``raystab_fast._merge_streams2``: the main stream's slots
  scattered to ray order, the near-origin stream merged by (t, lowest id))
  fused with X.6's tail in grid order, through the accel's ray -> slot map
  (:func:`ray_slots`).

Each wrapper launches its kernel on a CUDA tensor (or raises: no fallback)
and takes its plain version, today's torch chain kept as it was, on a CPU
tensor or under ``use_kernel=False``. The ``*_mirror`` functions replay
each kernel's index arithmetic and rounding in numpy, thread by thread, for
the CPU tests.
"""

from __future__ import annotations

import numpy as np
import torch

from dxrvoxelizer_tpu_torch.ops import _cuda
from dxrvoxelizer_tpu_torch.ops.packing import (
    pack_bits_z,
    quantize_r10g10b10a2,
    unpack_bits_z,
)
from dxrvoxelizer_tpu_torch.ops.warp import perm_for_axis

_SRC = "dxrvoxelizer_tpu_torch/csrc/grid.cu"
UNTILE = _cuda.Kernel(
    name="grid_untile",
    symbol="grid_untile_kernel",  # <gated, rounded>
    source=_SRC,
    replaces="dxrvoxelizer_tpu/ops/raystab_tiled.py:521",
)
UNPACK = _cuda.Kernel(
    name="grid_unpack",
    symbol="grid_unpack_kernel",
    source=_SRC,
    replaces="dxrvoxelizer_tpu/core/pipeline.py:57",
)
SLABS = _cuda.Kernel(
    name="grid_slabs",
    symbol="grid_slabs_kernel",
    source=_SRC,
    replaces="dxrvoxelizer_tpu/ops/raymarch_warp.py:461",
)
MERGE = _cuda.Kernel(
    name="grid_merge",
    symbol="grid_merge_kernel",  # <near-origin, gated, rounded>
    source=_SRC,
    replaces="dxrvoxelizer_tpu/ops/raystab_fast.py:1956",
)

TILE = (8, 4, 4)  # the gen-7 voxel tile, x-major; lane lx * 16 + ly * 4 + lz
SLAB_THREADS = 256  # X.8's threads a block
SLAB_ITEMS = 2  # X.8 rows: quads (or voxels) a thread
SLAB_TILE_K, SLAB_TILE_Y, SLAB_TILE_X = 32, 32, 2  # X.8 transpose: tile, slabs x
# X.8's paths (csrc/grid.cu SlabPath): rows or the transpose, each of
# 16-byte quads or of single voxels
ROWS_QUAD, ROWS_VOXEL, TRANS_QUAD, TRANS_VOXEL = range(4)
# the float32 reciprocals PyTorch's CUDA division by a Python scalar
# multiplies by (csrc/grid.cu rounds with them)
INV_1023 = np.float32(1.0) / np.float32(1023.0)
INV_3 = np.float32(1.0) / np.float32(3.0)


def tile_slots(tids: torch.Tensor, n: int) -> torch.Tensor:
    """Live tile ids [L] (ascending) -> the tile -> row map int32
    [n^3 / 128] that X.6 reads: row l of the live tiles' channels for tile
    ``tids[l]``, -1 for a dead tile. Built once per accel."""
    slots = torch.full((n ** 3 // 128,), -1, dtype=torch.int32,
                       device=tids.device)
    slots[tids] = torch.arange(tids.shape[0], dtype=torch.int32,
                               device=tids.device)
    return slots


def ray_slots(slot_ray: torch.Tensor, v: int) -> torch.Tensor:
    """A gen-6 accel's slot -> ray index [S*128] (``v`` for a padding
    slot) -> the ray -> slot map int32 [v] that X.10 reads: the slot of ray
    r, -1 where no strip covers it. Built once per accel (the strips
    partition the rays: each ray has at most one slot)."""
    slots = torch.full((v + 1,), -1, dtype=torch.int32, device=slot_ray.device)
    slots[slot_ray] = torch.arange(slot_ray.shape[0], dtype=torch.int32,
                                   device=slot_ray.device)
    return slots[:v]  # the padding slots' dump row dropped


# ---- X.6: untile, round, pack ---------------------------------------------

def untile_tiles_plain(ns: torch.Tensor | None, tids: torch.Tensor,
                       n: int) -> torch.Tensor:
    """The live tiles' channels ``ns`` [L, 128, 4] (None: no live tile) ->
    rgba [n,n,n,4] f32 in grid order: scattered into a zeroed tile buffer
    (dead tiles stay zero) and untiled by one permute (a view)."""
    tx, ty, tz = TILE
    out = torch.zeros((n * n * n // 128, 128, 4), dtype=torch.float32,
                      device=tids.device)
    if ns is not None:
        out.index_copy_(0, tids, ns)
    return (out.reshape(n // tx, n // ty, n // tz, tx, ty, tz, 4)
            .permute(0, 3, 1, 4, 2, 5, 6).reshape(n, n, n, 4))


def untile_plain(src: torch.Tensor | None, n: int, tiles=None,
                 gate: torch.Tensor | None = None, quantize: bool = True,
                 words: bool = True):
    """Plain version of :func:`untile`: the port's torch chain -> (rgba
    [n,n,n,4], words [n,n,n/32] int32 or None, None: the grid's density is
    ``rgba[..., 3]``)."""
    if tiles is not None:
        rgba = untile_tiles_plain(src, tiles[0], n)
    else:
        rgba = src.reshape(n, n, n, 4)
    w = None
    if gate is not None:
        occ_f = unpack_bits_z(gate, n).to(torch.float32)[..., None]
        rgba = torch.cat([rgba[..., :3] * occ_f, occ_f], dim=-1)
    elif words:
        w = pack_bits_z(rgba[..., 3] != 0.0)
    if quantize:
        rgba = quantize_r10g10b10a2(rgba)
    return rgba, w, None


def untile(src: torch.Tensor | None, n: int, tiles=None,
           gate: torch.Tensor | None = None, quantize: bool = True,
           words: bool = True, density: bool = True,
           use_kernel: bool = True):
    """Channels -> the grid: (rgba [n,n,n,4] f32, words [n,n,n/32] int32 or
    None, density [n,n,n] f32 or None).

    ``tiles`` = (tids, slots) of a gen-7 accel: ``src`` holds its live
    tiles' channels [L, 128, 4] (None when no tile is live). Without
    ``tiles``, ``src`` is [n^3, 4] in grid order: the plain version only
    (a tensor off the CPU raises; :func:`merge` is the card's grid-order
    route). ``gate`` (words): the ``-normals`` form, rgb times the
    occupancy bit and alpha the bit; no words come out. Otherwise the words
    are the unrounded alpha != 0 (``words``; n % 32 == 0).
    ``quantize`` rounds through R10G10B10A2. The kernel also writes the
    rounded alpha as a contiguous density (``density``); the plain version
    returns None there. One launch on a CUDA tensor; the plain version on a
    CPU tensor or under ``use_kernel=False``."""
    dev = tiles[1].device if tiles is not None else src.device
    if not use_kernel or dev.type == "cpu":
        return untile_plain(src, n, tiles, gate, quantize, words)
    if tiles is None:
        raise ValueError(f"src on {dev}: the grid-order form has no kernel "
                         "(gen-6's streams go through merge); pass tiles or "
                         "use_kernel=False")
    want_words = gate is None and words
    if n % 8:
        raise ValueError(f"tiled grids need n % 8 == 0, got {n}")
    if (gate is not None or want_words) and n % 32:
        raise ValueError(f"packed grids need n % 32 == 0, got {n}")
    _cuda.require(tiles[1], "slots", torch.int32, (n ** 3 // 128,))
    if src is not None:
        _cuda.require(src, "src", torch.float32, (src.shape[0], 128, 4))
    if gate is not None:
        _cuda.require(gate, "gate", torch.int32, (n, n, n // 32))
    rgba = torch.empty((n, n, n, 4), dtype=torch.float32, device=dev)
    dens = (torch.empty((n, n, n), dtype=torch.float32, device=dev)
            if density else None)
    w = (torch.empty((n, n, n // 32), dtype=torch.int32, device=dev)
         if want_words else None)
    code = _cuda.load().dxv_grid_untile(
        0 if src is None else src.data_ptr(), tiles[1].data_ptr(),
        0 if gate is None else gate.data_ptr(), rgba.data_ptr(),
        0 if dens is None else dens.data_ptr(),
        0 if w is None else w.data_ptr(), n, int(quantize),
        _cuda.stream_ptr(dev))
    _cuda.check(code, UNTILE.name)
    UNTILE.launches += 1
    return rgba, w, dens


# ---- X.10: gen-6's stream merge, round, pack --------------------------------

def merge_plain(accel, outs: dict, gate: torch.Tensor | None = None,
                quantize: bool = True, words: bool = True):
    """Plain version of :func:`merge`: ``raystab_fast._merge_streams2``,
    then :func:`untile_plain`'s grid-order form."""
    from dxrvoxelizer_tpu_torch.ops.raystab_fast import _merge_streams2

    return untile_plain(_merge_streams2(accel, outs), accel.n, gate=gate,
                        quantize=quantize, words=words)


def _flat_stride(x: torch.Tensor, inner: int, name: str) -> int:
    """The stride, in elements, between consecutive entries of ``x``
    flattened over all but its last ``inner`` dims (which must be
    contiguous): how X.10 reads a stream's outputs in place, a strided view
    of the sharded frames' gathered pieces included. Raises when ``x`` is
    laid out otherwise."""
    lead = x.dim() - inner
    dims = list(zip(x.shape, x.stride()))
    es = next((st for size, st in reversed(dims[:lead]) if size > 1), 1)
    for part, first in ((dims[lead:], 1), (dims[:lead], es)):
        want = first
        for size, st in reversed(part):
            if size > 1 and st != want:
                raise ValueError(f"{name}: its entries are not one stride "
                                 f"apart (shape {tuple(x.shape)}, strides "
                                 f"{x.stride()})")
            want *= size
    return es


def _stream_args(name: str, out, count: int, dev) -> tuple:
    """One stream's (t, id, ns) -> X.10's pointers and strides (t and id
    share one): each entry read in place."""
    t, i, ns = out
    _cuda.require(t, f"{name} t", torch.float32, contiguous=False)
    if (i.dtype != torch.int32 or ns.dtype != torch.float32
            or i.shape != t.shape or ns.shape[:-1] != t.shape
            or ns.shape[-1] != 4 or i.device != dev or ns.device != dev
            or t.device != dev or t.numel() < count):
        raise ValueError(
            f"{name}: expected t f32, id int32 and ns f32 [..., 4] of at "
            f"least {count} entries on {dev}, got {t.dtype} "
            f"{tuple(t.shape)}, {i.dtype} {tuple(i.shape)}, {ns.dtype} "
            f"{tuple(ns.shape)} on {t.device}")
    if t.is_contiguous() and i.is_contiguous() and ns.is_contiguous():
        ts, nss = 1, 4  # the fold's own outputs
    else:
        ts = _flat_stride(t, 0, f"{name} t")
        if _flat_stride(i, 0, f"{name} id") != ts:
            raise ValueError(f"{name}: t and id must share one stride")
        nss = _flat_stride(ns, 1, f"{name} ns")
    return t.data_ptr(), i.data_ptr(), ns.data_ptr(), ts, nss


def merge(accel, outs: dict, gate: torch.Tensor | None = None,
          quantize: bool = True, words: bool = True, density: bool = True,
          use_kernel: bool = True):
    """A gen-6 accel's stream outputs (``outs[name] = (t, id, ns)`` for
    "main" and "ov", those it has; strided views are read in place) ->
    (rgba [n,n,n,4] f32, words [n,n,n/32] int32 or None, density [n,n,n]
    f32 or None), as :func:`untile_plain`'s grid-order form gives from the
    merged channels: ray r takes its main slot's channels (``accel.ray_slot``;
    zeros where no strip covers it), or the near-origin stream's lane r
    where that is closer (equal t: the lower id). ``gate``, ``quantize``,
    ``words`` and ``density`` as for :func:`untile`. One launch on a CUDA
    tensor; the plain version (:func:`merge_plain`) on a CPU tensor or
    under ``use_kernel=False``."""
    dev = accel.device
    if not use_kernel or dev.type == "cpu":
        return merge_plain(accel, outs, gate, quantize, words)
    n = accel.n
    v = n ** 3
    want_words = gate is None and words
    if (gate is not None or want_words) and n % 32:
        raise ValueError(f"packed grids need n % 32 == 0, got {n}")
    slot = 0
    m_args = o_args = (0, 0, 0, 0, 0)
    if "main" in outs:
        _cuda.require(accel.ray_slot, "ray_slot", torch.int32, (v,))
        slot = accel.ray_slot.data_ptr()
        m_args = _stream_args("main", outs["main"], accel.slot_ray.numel(), dev)
    if "ov" in outs:
        o_args = _stream_args("ov", outs["ov"], v, dev)
    if gate is not None:
        _cuda.require(gate, "gate", torch.int32, (n, n, n // 32))
    rgba = torch.empty((n, n, n, 4), dtype=torch.float32, device=dev)
    dens = (torch.empty((n, n, n), dtype=torch.float32, device=dev)
            if density else None)
    w = (torch.empty((n, n, n // 32), dtype=torch.int32, device=dev)
         if want_words else None)
    code = _cuda.load().dxv_grid_merge(
        slot, *m_args, *o_args, 0 if gate is None else gate.data_ptr(),
        rgba.data_ptr(), 0 if dens is None else dens.data_ptr(),
        0 if w is None else w.data_ptr(), n, int(quantize),
        _cuda.stream_ptr(dev))
    _cuda.check(code, MERGE.name)
    MERGE.launches += 1
    return rgba, w, dens


# ---- X.7: words -> density --------------------------------------------------

def unpack_density_plain(words: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of :func:`unpack_density`: ``unpack_bits_z`` and a
    float cast."""
    return unpack_bits_z(words, n).to(torch.float32)


def unpack_density(words: torch.Tensor, n: int,
                   use_kernel: bool = True) -> torch.Tensor:
    """Occupancy words [n,n,n/32] -> density [n,n,n] f32 (1 inside, 0
    outside): one launch on a CUDA tensor, the plain version on a CPU
    tensor or under ``use_kernel=False``."""
    if not use_kernel or words.device.type == "cpu":
        return unpack_density_plain(words, n)
    if n % 32:
        raise ValueError(f"packed grids need n % 32 == 0, got {n}")
    _cuda.require(words, "words", torch.int32, (n, n, n // 32))
    out = torch.empty((n, n, n), dtype=torch.float32, device=words.device)
    code = _cuda.load().dxv_grid_unpack(words.data_ptr(), out.data_ptr(), n,
                                        _cuda.stream_ptr(words.device))
    _cuda.check(code, UNPACK.name)
    UNPACK.launches += 1
    return out


# ---- X.8: the march's slab stack ---------------------------------------------

def to_slab_order(vol: torch.Tensor, perm, flip: bool) -> torch.Tensor:
    """[N,N,N] volume -> [K, X, Y] view with the marching axis first."""
    v = vol.permute(*perm)  # [X, Y, K]
    if flip:
        v = v.flip(-1)
    return v.movedim(-1, 0)


def slabs_plain(density: torch.Tensor, light: torch.Tensor, axis: int,
                flip: bool) -> torch.Tensor:
    """Plain version of :func:`slabs`: one stack of the two slab-order
    views (also the one PyTorch call that computes the function)."""
    perm = perm_for_axis(axis)
    return torch.stack(
        [to_slab_order(density, perm, flip), to_slab_order(light, perm, flip)]
    ).contiguous()  # [2, K, X, Y]


def _slab_strides(vol: torch.Tensor, axis: int) -> tuple[int, int, int]:
    """A volume's element strides along the slab's x, y and the marching
    axis."""
    a, b, k = perm_for_axis(axis)
    return vol.stride(a), vol.stride(b), vol.stride(k)


def slabs(density: torch.Tensor, light: torch.Tensor, axis: int, flip: bool,
          use_kernel: bool = True) -> torch.Tensor:
    """Density and light [N,N,N] -> the march's slabs [2, K, X, Y], the
    marching ``axis`` first (reversed when ``flip``), the other two in grid
    order. One launch on CUDA tensors (either may be strided: the kernel
    reads them in place), the plain version on CPU tensors or under
    ``use_kernel=False``."""
    if not use_kernel or density.device.type == "cpu":
        return slabs_plain(density, light, axis, flip)
    n = int(density.shape[0])
    for name, t in (("density", density), ("light", light)):
        _cuda.require(t, name, torch.float32, (n, n, n), contiguous=False)
    if light.device != density.device:
        raise ValueError(f"light: expected {density.device}, got "
                         f"{light.device}")
    if axis not in (0, 1, 2):
        raise ValueError(f"axis must be 0, 1 or 2, got {axis}")
    out = torch.empty((2, n, n, n), dtype=torch.float32, device=density.device)
    code = _cuda.load().dxv_grid_slabs(
        density.data_ptr(), *_slab_strides(density, axis), light.data_ptr(),
        *_slab_strides(light, axis), out.data_ptr(), n, int(flip),
        _cuda.stream_ptr(density.device))
    _cuda.check(code, SLABS.name)
    SLABS.launches += 1
    return out


# ---- the kernels' index arithmetic and rounding, replayed in numpy ----------

def _unorm_card(v: np.ndarray, levels: float, inv: np.float32) -> np.ndarray:
    """The card's R10G10B10A2 channel: clamp (NaN stays), times ``levels``,
    round half to even, times the float32 reciprocal."""
    c = np.clip(v, np.float32(0.0), np.float32(1.0))
    return (np.rint(c * np.float32(levels)) * inv).astype(np.float32)


def untile_mirror(src: np.ndarray | None, n: int, slots: np.ndarray,
                  gate: np.ndarray | None = None, quantize: bool = True,
                  words: bool = True):
    """X.6 thread by thread (thread v = voxel v of grid order; the slot and
    lane of its tile; the warp's ballot into word v >> 5, bit v & 31) ->
    (rgba [n,n,n,4], words int32 or None, density [n,n,n])."""
    voxels = n ** 3
    v = np.arange(voxels, dtype=np.int64)
    k = v % n
    row = v // n
    j, i = row % n, row // n
    q = n >> 2
    tile = ((i >> 3) * q + (j >> 2)) * q + (k >> 2)
    lane = (i & 7) * 16 + (j & 3) * 4 + (k & 3)
    s = slots[tile].astype(np.int64)
    c = np.zeros((voxels, 4), np.float32)
    live = s >= 0
    if src is not None:
        c[live] = src.reshape(-1, 4)[s[live] * 128 + lane[live]]
    return _finish_mirror(c, n, gate, quantize, words)


def _finish_mirror(c: np.ndarray, n: int, gate: np.ndarray | None,
                   quantize: bool, words: bool):
    """X.6's tail (shared with X.10), thread by thread: voxel v's
    channels ``c[v]`` [n^3, 4] -> (rgba, words or None, density)."""
    v = np.arange(n ** 3, dtype=np.int64)
    k = v % n
    w = None
    if gate is not None:
        bit = ((gate.reshape(-1).view(np.uint32)[v >> 5] >> (k & 31).astype(
            np.uint32)) & np.uint32(1)).astype(np.float32)
        with np.errstate(invalid="ignore"):
            c[:, :3] = c[:, :3] * bit[:, None]
        c[:, 3] = bit
    elif words and n % 32 == 0:
        bits = (c[:, 3] != 0.0).astype(np.uint64).reshape(-1, 32)
        lanes = np.arange(32, dtype=np.uint64)
        w = ((bits << lanes).sum(-1).astype(np.uint32).view(np.int32)
             .reshape(n, n, n // 32))
    if quantize:
        c[:, :3] = _unorm_card(c[:, :3], 1023.0, INV_1023)
        c[:, 3] = _unorm_card(c[:, 3], 3.0, INV_3)
    return c.reshape(n, n, n, 4), w, c[:, 3].reshape(n, n, n).copy()


def merge_mirror(n: int, ray_slot: np.ndarray | None, main, ov,
                 gate: np.ndarray | None = None, quantize: bool = True,
                 words: bool = True):
    """X.10 thread by thread: ray v's slot ``ray_slot[v]`` (-1: zeros,
    t = +inf, id = 2^30) in ``main`` = (t, id, ns) flattened over the
    slots, then lane v of ``ov`` (or None) where its t is smaller or equal
    with a lower id; then X.6's tail -> (rgba, words or None, density)."""
    voxels = n ** 3
    c = np.zeros((voxels, 4), np.float32)
    t = np.full(voxels, np.inf, np.float32)
    i = np.full(voxels, 1 << 30, np.int32)
    if ray_slot is not None:
        s = ray_slot.astype(np.int64)
        hit = s >= 0
        m_t, m_i, m_ns = (np.asarray(a).reshape(-1, *a.shape[2:])
                          for a in main)
        c[hit] = m_ns[s[hit]]
        t[hit], i[hit] = m_t[s[hit]], m_i[s[hit]]
    if ov is not None:
        o_t, o_i, o_ns = (np.asarray(a).reshape(-1, *a.shape[2:])[:voxels]
                          for a in ov)
        closer = (o_t < t) | ((o_t == t) & (o_i < i))
        c[closer] = o_ns[closer]
    return _finish_mirror(c, n, gate, quantize, words)


def unpack_mirror(words: np.ndarray, n: int) -> np.ndarray:
    """X.7 thread by thread: thread q writes voxels 4q..4q+3 from word
    q >> 3, shifted by (q & 7) * 4."""
    q = np.arange(n ** 3 // 4, dtype=np.int64)
    w = words.reshape(-1).view(np.uint32)[q >> 3] >> ((q & 7) * 4).astype(
        np.uint32)
    out = np.stack([(w >> np.uint32(b)) & np.uint32(1) for b in range(4)], -1)
    return out.astype(np.float32).reshape(n, n, n)


def slab_path(offset: int, strides: tuple[int, int, int], n: int) -> int:
    """X.8's path for one channel (``csrc/grid.cu`` ``slab_path``): rows
    when its y stride is below its marching stride, else the transpose;
    16-byte quads where n % 4 == 0 and the loaded quads are contiguous and
    16-byte aligned (``offset``: the volume's first element, in floats from
    a 16-byte boundary)."""
    sx, sy, sk = strides
    aligned = n % 4 == 0 and sx % 4 == 0 and offset % 4 == 0
    if not sk < sy:
        return ROWS_QUAD if aligned and sy == 1 and sk % 4 == 0 else ROWS_VOXEL
    return TRANS_QUAD if aligned and sk == 1 and sy % 4 == 0 else TRANS_VOXEL


def slab_blocks(path: int, n: int) -> int:
    """Blocks X.8 gives one channel on ``path``."""
    if path in (ROWS_QUAD, ROWS_VOXEL):
        items = n * n * (n // 4 if path == ROWS_QUAD else n)
        return -(-items // (SLAB_THREADS * SLAB_ITEMS))
    return -(-n // SLAB_TILE_Y) * -(-n // SLAB_TILE_K) * -(-n // SLAB_TILE_X)


def _slab_quot(i: np.ndarray, inv: float) -> np.ndarray:
    """X.8's quotient: (i + 0.5) times the float64 reciprocal, truncated."""
    return ((i.astype(np.float64) + 0.5) * inv).astype(np.int64)


def _slab_rows_mirror(buf, off, strides, n, flip, quad, out):
    """X.8's rows path, thread by thread: block b, item j, lane t -> item
    i = (b * SLAB_ITEMS + j) * SLAB_THREADS + t of the output in order, its
    row and voxel row through the float64 reciprocals of n / 4 (or n) and
    n (each quotient asserted exact)."""
    sx, sy, sk = strides
    per_row = n // 4 if quad else n
    inv_n = 1.0 / n
    items = n * n * per_row
    b, j, t = np.meshgrid(np.arange(slab_blocks(
        ROWS_QUAD if quad else ROWS_VOXEL, n)), np.arange(SLAB_ITEMS),
        np.arange(SLAB_THREADS), indexing="ij")
    i = ((b * SLAB_ITEMS + j) * SLAB_THREADS + t).reshape(-1)
    i = i[i < items]
    row = _slab_quot(i, 4.0 * inv_n if quad else inv_n)
    y = (i - row * per_row) * (4 if quad else 1)
    k = _slab_quot(row, inv_n)
    x = row - k * n
    assert (row == i // per_row).all() and (k == row // n).all()
    kk = n - 1 - k if flip else k
    src = off + x * sx + y * sy + kk * sk
    if quad:  # one 16-byte load and store: 4 contiguous, aligned floats
        assert (src % 4 == 0).all() and sy == 1
        for e in range(4):
            out[4 * i + e] = buf[src + e]
    else:
        out[i] = buf[src]


def _slab_transpose_mirror(buf, off, strides, n, flip, path, out):
    """X.8's transpose path, thread by thread: block b's (k, y) tile of
    SLAB_TILE_X slabs x, loaded into the shared tile (input k rows from kb),
    then stored from it (output row kl from tile row kl, or SLAB_TILE_K - 1
    - kl when flipped)."""
    sx, sy, sk = strides
    TK, TY, TX, NT = SLAB_TILE_K, SLAB_TILE_Y, SLAB_TILE_X, SLAB_THREADS
    blocks = slab_blocks(path, n)
    b, t, xi = np.meshgrid(np.arange(blocks), np.arange(NT), np.arange(TX),
                           indexing="ij")
    ty, tk = -(-n // TY), -(-n // TK)
    y0, k0, x0 = (b % ty) * TY, ((b // ty) % tk) * TK, (b // ty // tk) * TX
    kb = n - k0 - TK if flip else k0
    x = x0 + xi
    tile = np.full((blocks, TX, TK, TY + 1), np.nan, np.float32)
    zero = np.float32(0.0)
    quad = path == TRANS_QUAD  # 16-byte quads both ways, else voxels
    lanes = TK // 4 if quad else TK  # lanes along k
    passes = NT // lanes  # tile rows y a pass
    kl = (t % lanes) * (4 if quad else 1)
    k = kb + kl
    for r in range(TY // passes):
        yl = t // lanes + passes * r
        y = y0 + yl
        ok = (x < n) & (y < n) & (k >= 0) & (k < n)
        src = off + x * sx + y * sy + k * (1 if quad else sk)
        if quad:  # one 16-byte load of 4 k
            assert (src[ok] % 4 == 0).all() and sk == 1
        for e in range(4 if quad else 1):
            tile[b, xi, kl + e, yl] = np.where(ok, buf[np.where(ok, src + e, 0)],
                                               zero)
    lanes = TY // 4 if quad else TY  # lanes along y
    passes = NT // lanes  # output rows k a pass
    yl = (t % lanes) * (4 if quad else 1)
    y = y0 + yl
    for r in range(TK // passes):
        kl = t // lanes + passes * r
        k = k0 + kl
        kt = TK - 1 - kl if flip else kl
        ok = (x < n) & (y < n) & (k < n)
        dst = (k * n + x) * n + y
        if quad:  # one 16-byte store of 4 y
            assert (dst[ok] % 4 == 0).all()
        for e in range(4 if quad else 1):
            out[dst[ok] + e] = tile[b[ok], xi[ok], kt[ok], yl[ok] + e]


def slabs_mirror(vols, n: int, axis: int, flip: bool) -> np.ndarray:
    """X.8 block by block: ``vols`` = ((flat buffer, offset, (sx, sy, sk)))
    for density and light, each read through its strides on its own path
    (:func:`slab_path`; the buffer starts 16-byte aligned) -> out [2, n, n,
    n] (NaN where no store landed). A 16-byte access asserts that its 4
    floats are contiguous and aligned."""
    out = np.full((2, n ** 3), np.nan, np.float32)
    for c, (buf, off, strides) in enumerate(vols):
        path = slab_path(off, strides, n)
        if path in (ROWS_QUAD, ROWS_VOXEL):
            _slab_rows_mirror(buf, off, strides, n, flip, path == ROWS_QUAD,
                              out[c])
        else:
            _slab_transpose_mirror(buf, off, strides, n, flip, path, out[c])
    return out.reshape(2, n, n, n)
