"""The frame's grid glue (ops/grid_cuda.py, csrc/grid.cu) on the CPU: X.6
(the gen-7 grid's untiling, R10G10B10A2 rounding and packing; its
words-gated form, and its grid-order plain version), X.7 (the words'
unpacking to density), X.8 (the march's slab stack) and X.10 (gen-6's
stream merge fused with X.6's tail, through the accel's ray -> slot map;
with an identity map, the card's grid-order form).

The kernels run only on the card (chip_smoke.py holds each against its
plain version there with ==). Here:

- the plain versions against the JAX package's functions on seeded numpy
  inputs, bit for bit: channels that are negative, above 1, signed zeros,
  infinities, NaN and products that land on exact .5 ties
  (``tests/torch_cases.quantize_cases``, found by a float32 search);
- each kernel's numpy mirror (its thread -> voxel, voxel -> tile row and
  lane, ballot and slab index arithmetic, and its rounding) against the
  plain version, bit for bit, at 16-128^3 and in all six (axis, flip)
  pairs. The rounding is the card's: PyTorch's CUDA division by a Python
  scalar multiplies by the float32 reciprocal, which the plain version is
  run with here (emulated); the CPU's IEEE quotient differs from it at 24
  of the 1,024 levels of a 10-bit channel, as JAX op by op differs from
  jitted JAX;
- the routing: a CPU tensor and ``use_kernel(s)=False`` take the plain
  versions, the frame's entry points pass the flag down, and a tensor that
  is not on the CPU goes to the kernel or raises, with no fallback; the
  card's routes (rehearsed here: the kernels' plain versions on CPU
  tensors) reach the old torch chains (``_fused_coef_matrix``,
  ``_merge_streams2``, ``untile7``, ``_stab_density``, ``unpack_bits_z``)
  only through a kernel's wrapper, and the sharded frames' new route gives
  the old chain's grid bit for bit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrvoxelizer_tpu.core.pipeline import VoxelGrid as JaxVoxelGrid
from dxrvoxelizer_tpu.ops import packing as jpack
from dxrvoxelizer_tpu.ops.raymarch_warp import _perm_for_axis as jax_perm
from dxrvoxelizer_tpu_torch.core import pipeline
from dxrvoxelizer_tpu_torch.core.pipeline import VoxelGrid
from dxrvoxelizer_tpu_torch.ops import _cuda, grid_cuda as gc
from dxrvoxelizer_tpu_torch.ops import raystab_fast as rf
from dxrvoxelizer_tpu_torch.ops import raystab_tiled as rt
from dxrvoxelizer_tpu_torch.ops.packing import (
    pack_bits_z,
    quantize_r10g10b10a2,
    unpack_bits_z,
)
from tests.meshes import icosphere_mesh
from tests.torch_cases import (
    _ties,
    grid_channels,
    grid_order_streams,
    packed_outs,
    quantize_cases,
)

torch.set_num_threads(2)

F32 = np.float32
AXIS_FLIP = [(a, f) for a in range(3) for f in (False, True)]
# the 10-bit levels k at which k * fl(1/1023) and fl(k / 1023) differ
RECIP_LEVELS = 24


def _bits(a) -> np.ndarray:
    """float32 values as their bit patterns (NaN, -0.0 compared exactly)."""
    return np.ascontiguousarray(np.asarray(a, F32)).view(np.int32)


def _same(a, b) -> bool:
    """Equal as the benchmark's hold compares (==, so -0.0 == 0.0), with
    NaN at the same places: torch.clamp keeps a -0.0 that jnp.clip turns
    into 0.0."""
    a, b = np.asarray(a), np.asarray(b)
    na, nb = np.isnan(a), np.isnan(b)
    return (a.shape == b.shape and np.array_equal(na, nb)
            and np.array_equal(a[~na], b[~nb]))


def _ftz(a: np.ndarray) -> np.ndarray:
    """Subnormals flushed to zero, as XLA:CPU computes (the port keeps them,
    on the CPU and the card)."""
    return np.where(np.abs(a) < np.finfo(F32).tiny, F32(0), a)


def _card_division(monkeypatch):
    """Run the plain versions with PyTorch's CUDA division by a Python
    scalar: the product by the scalar's float32 reciprocal."""
    div = torch.Tensor.__truediv__

    def card_div(a, b):
        if isinstance(b, (int, float)) and a.dtype == torch.float32:
            return a * torch.tensor(F32(1) / F32(b))
        return div(a, b)

    monkeypatch.setattr(torch.Tensor, "__truediv__", card_div)


def _channels(seed=0) -> np.ndarray:
    """[C, 4] channels: every case in every channel, shuffled per channel."""
    c = quantize_cases()
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(c) for _ in range(4)], -1)


# ---- against the JAX package -------------------------------------------------

def test_tie_search_finds_exact_halves():
    """Every level of both widths has a float32 whose product lands on
    m + 0.5 exactly, and rounding takes it to the even neighbour."""
    for levels in (1023, 3):
        t = _ties(levels)
        assert t.shape == (levels,)
        prod = (t * F32(levels)).astype(F32)
        assert np.array_equal(prod, np.arange(levels, dtype=F32) + F32(0.5))
        assert np.array_equal(np.rint(prod) % 2, np.zeros(levels))


def test_quantize_matches_jax_on_the_tie_set(monkeypatch):
    """R10G10B10A2 on the tie set, bit for bit: the plain version on the
    CPU against JAX op by op (IEEE quotients), and with the card's
    division (the kernel's rounding, and its mirror's) against jitted JAX,
    which multiplies by the reciprocal too. The two roundings differ
    exactly at the 24 levels where the reciprocal's product is an ulp off."""
    ch = _channels()
    eager = np.asarray(jpack.quantize_r10g10b10a2(jnp.asarray(ch)))
    jitted = np.asarray(jax.jit(jpack.quantize_r10g10b10a2)(jnp.asarray(ch)))
    got = quantize_r10g10b10a2(torch.from_numpy(ch)).numpy()
    assert _same(got, eager)
    _card_division(monkeypatch)
    card = quantize_r10g10b10a2(torch.from_numpy(ch)).numpy()
    assert _same(card, jitted)
    k = np.arange(1024, dtype=F32)[:, None].repeat(4, 1) / F32(1023)
    k[:, 3] = 0.0
    a = quantize_r10g10b10a2(torch.from_numpy(k)).numpy()
    monkeypatch.undo()
    b = quantize_r10g10b10a2(torch.from_numpy(k)).numpy()
    assert int((a[:, 0] != b[:, 0]).sum()) == RECIP_LEVELS
    assert np.array_equal(a[:, 3], b[:, 3])


def test_pack_and_unpack_match_jax():
    """The words (bit 31 the int32 sign) and their unpacking, bit for bit."""
    rng = np.random.default_rng(3)
    for n in (32, 64):
        occ = rng.random((n, n, n)) < 0.5
        occ[0, 0, 31] = occ[-1, -1, -1] = True
        w = pack_bits_z(torch.from_numpy(occ)).numpy()
        assert np.array_equal(w, np.asarray(jpack.pack_bits_z(jnp.asarray(occ))))
        assert (w < 0).any()
        back = unpack_bits_z(torch.from_numpy(w), n).numpy()
        assert np.array_equal(back, np.asarray(jpack.unpack_bits_z(
            jnp.asarray(w), n)))
        assert np.array_equal(back, occ)


def _jax_untile(ns: np.ndarray, tids: np.ndarray, n: int) -> np.ndarray:
    """dxrvoxelizer_tpu/ops/raystab_tiled.py:521-531 on the live tiles'
    channels: the scatter into [nt + 1, 4, 128] and the untiling."""
    tx, ty, tz = (8, 4, 4)
    nt = n ** 3 // 128
    out = jnp.zeros((nt + 1, 4, 128), jnp.float32)
    out = out.at[jnp.asarray(tids)].set(jnp.asarray(ns).transpose(0, 2, 1))
    rgba = (out[:nt].reshape(n // tx, n // ty, n // tz, 4, tx, ty, tz)
            .transpose(0, 4, 1, 5, 2, 6, 3).reshape(n, n, n, 4))
    return np.asarray(rgba)


@pytest.mark.parametrize("n", [16, 32, 64])
def test_untile_and_grid_match_jax(n):
    """X.6's plain version against JAX: the untiling (dead tiles zero), then
    the frame's grid, ``quantize_r10g10b10a2`` of it and ``pack_bits_z`` of
    its unrounded alpha != 0 (core/pipeline.py:128), bit for bit."""
    d = grid_channels(n, n)
    tids = torch.from_numpy(d["tids"])
    want = _jax_untile(d["ns"], d["tids"], n)
    got = gc.untile_tiles_plain(torch.from_numpy(d["ns"]), tids, n).numpy()
    assert np.array_equal(_bits(got), _bits(want))
    tiles = (tids, gc.tile_slots(tids, n))
    if n % 32:
        rgba, w, dens = gc.untile(torch.from_numpy(d["ns"]), n, tiles=tiles,
                                  words=False)
        assert w is None
    else:
        rgba, w, dens = gc.untile(torch.from_numpy(d["ns"]), n, tiles=tiles)
        assert np.array_equal(w.numpy(), np.asarray(jpack.pack_bits_z(
            jnp.asarray(want[..., 3] != 0.0))))
    assert dens is None
    q = np.asarray(jpack.quantize_r10g10b10a2(jnp.asarray(want)))
    assert _same(rgba.numpy(), q)


@pytest.mark.parametrize("n", [32, 64])
def test_gated_form_matches_jax(n):
    """X.6's words-gated form (``-normals``): rgb times the occupancy bit,
    alpha the bit (JAX's _parity_rgba, dxrvoxelizer_tpu/core/pipeline.py:
    207-213), then the rounding, bit for bit: a negative normal times 0 is
    -0.0, NaN and infinity times 0 NaN; a subnormal channel stays (XLA:CPU
    flushes it to zero)."""
    d = grid_channels(n, 7 + n, tiles=False)
    src, gate = d["src"], d["gate"]
    occ_f = jpack.unpack_bits_z(jnp.asarray(gate), n).astype(jnp.float32)[..., None]
    hit = jnp.asarray(src.reshape(n, n, n, 4))
    want = jnp.concatenate([hit[..., :3] * occ_f, occ_f], axis=-1)
    for q in (False, True):
        w_q = np.asarray(jpack.quantize_r10g10b10a2(want) if q else want)
        rgba, w, dens = gc.untile(torch.from_numpy(src), n,
                                  gate=torch.from_numpy(gate), quantize=q)
        assert w is None and dens is None
        if q:
            assert _same(rgba.numpy(), w_q)
        else:  # XLA:CPU flushes subnormal products to zero; torch keeps them
            assert _same(_ftz(rgba.numpy()), w_q)
    assert (_bits(np.asarray(want)[..., :3]) == _bits(F32(-0.0))).any()


def test_unpack_density_matches_jax():
    """X.7's plain version against JAX's ``VoxelGrid.density`` of a parity
    grid (dxrvoxelizer_tpu/core/pipeline.py:57-64)."""
    for n in (32, 64):
        w = grid_channels(n, n, tiles=False)["gate"]
        want = np.asarray(JaxVoxelGrid(words=jnp.asarray(w)).density())
        got = gc.unpack_density(torch.from_numpy(w), n)
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(VoxelGrid(words=torch.from_numpy(w)).density()
                              .numpy(), want)


def _jax_slabs(density, light, axis, flip) -> np.ndarray:
    """dxrvoxelizer_tpu/ops/raymarch_warp.py:461-465."""
    perm = jax_perm(axis)
    vol2 = jnp.stack([jnp.asarray(density), jnp.asarray(light)], axis=0)
    vol2 = jnp.transpose(vol2, (0, *[p + 1 for p in perm]))
    if flip:
        vol2 = vol2[..., ::-1]
    return np.asarray(jnp.moveaxis(vol2, -1, 1))


@pytest.mark.parametrize("axis,flip", AXIS_FLIP)
def test_slabs_match_jax(axis, flip):
    """X.8's plain version against JAX's slab stack, every (axis, flip)."""
    rng = np.random.default_rng(axis * 2 + flip)
    for n in (16, 32, 48):
        d = rng.random((n, n, n), dtype=F32)
        lt = rng.random((n, n, n), dtype=F32)
        got = gc.slabs(torch.from_numpy(d), torch.from_numpy(lt), axis, flip)
        assert np.array_equal(got.numpy(), _jax_slabs(d, lt, axis, flip))


# ---- the kernels' mirrors against the plain versions -----------------------

# (n, form): every form at the packed sizes; the tiled form alone at 16^3
# (n % 8 == 0 without words)
UNTILE_CASES = [(n, form) for n in (16, 32, 64, 128)
                for form in ("tiled", "grid", "gated_tiled", "gated_grid")
                if n % 32 == 0 or form == "tiled"]


@pytest.mark.parametrize("n,form", UNTILE_CASES)
def test_untile_mirror_matches_plain(monkeypatch, n, form):
    """X.6's mirror (a thread a voxel; tile ((i>>3) (n/4) + (j>>2)) (n/4) +
    (k>>2), lane (i&7) 16 + (j&3) 4 + (k&3) through the slot map, dead tiles
    zero; the warp's ballot as word v >> 5) against the plain chain with
    the card's division, rounding on and off, bit for bit; its density is
    the rounded alpha. The grid-order forms have no X.6 kernel: there X.10's
    mirror with an identity ray -> slot map is held against X.6's
    grid-order plain version."""
    tiled = form.endswith("tiled")
    _card_division(monkeypatch)
    d = grid_channels(n, 100 + n, tiles=tiled)
    gate = d.get("gate") if form.startswith("gated") else None
    if tiled:
        tids = torch.from_numpy(d["tids"])
        slots = gc.tile_slots(tids, n)
        src, tiles = d["ns"], (tids, slots)
        assert np.array_equal(np.sort(slots.numpy()[slots.numpy() >= 0]),
                              np.arange(len(d["tids"])))
    else:
        src, tiles = d["src"], None
    words = n % 32 == 0
    for q in (False, True):
        rgba, w, _ = gc.untile(torch.from_numpy(src), n, tiles=tiles,
                               gate=None if gate is None else torch.from_numpy(gate),
                               quantize=q, words=words)
        if tiled:
            m_rgba, m_w, m_dens = gc.untile_mirror(src, n, slots.numpy(),
                                                   gate, q, words)
        else:
            m_rgba, m_w, m_dens = _grid_order_mirror(src, n, gate, q, words)
        # rounded, a -0.0 compares by == (np.clip and the CPU's torch.clamp
        # give it different signs; on the card the kernel's is the plain
        # version's, bit for bit); unrounded, every bit
        same = _same if q else (lambda a, b: np.array_equal(_bits(a), _bits(b)))
        assert same(m_rgba, rgba.numpy())
        assert same(m_dens, rgba.numpy()[..., 3])
        assert (m_w is None) == (w is None)
        if w is not None:
            assert np.array_equal(m_w, w.numpy())


def _grid_order_mirror(src: np.ndarray, n: int, gate=None, quantize=True,
                       words=True):
    """The card's grid-order form: X.10's mirror on the channels as one main
    stream read through an identity ray -> slot map."""
    accel, outs = grid_order_streams(torch.from_numpy(src), n)
    return gc.merge_mirror(n, accel.ray_slot.numpy(),
                           tuple(a.numpy() for a in outs["main"]), None,
                           gate, quantize, words)


def test_untile_mirror_on_the_tie_set(monkeypatch):
    """Every tie-set value in every channel through the grid-order form (on
    the card, X.10 with an identity ray -> slot map): the mirror's rounding
    equals the plain chain with the card's division and jitted JAX, bit for
    bit; the words are the unrounded alpha != 0 (a NaN alpha sets its bit,
    an alpha below 1/6 keeps it though it rounds to 0)."""
    ch = _channels(1)
    n = 32
    src = np.zeros((n ** 3, 4), F32)
    src[: len(ch)] = ch
    _card_division(monkeypatch)
    rgba, w, _ = gc.untile(torch.from_numpy(src), n)
    m_rgba, m_w, _ = _grid_order_mirror(src, n)
    accel, outs = grid_order_streams(torch.from_numpy(src), n)
    g_rgba, g_w, _ = gc.merge(accel, outs)  # X.10's plain version
    assert _same(g_rgba.numpy(), rgba.numpy())
    assert np.array_equal(g_w.numpy(), w.numpy())
    assert _same(m_rgba, rgba.numpy())
    assert np.array_equal(m_w, w.numpy())
    jitted = np.asarray(jax.jit(jpack.quantize_r10g10b10a2)(jnp.asarray(src)))
    assert _same(m_rgba.reshape(-1, 4), jitted)
    occ = unpack_bits_z(w, n).numpy().reshape(-1)
    assert np.array_equal(occ, src[:, 3] != 0)
    assert (occ & (m_rgba.reshape(-1, 4)[:, 3] == 0)).any()


@pytest.mark.parametrize("n", [32, 64, 128])
def test_unpack_mirror_matches_plain(n):
    """X.7's mirror (a thread four voxels: word q >> 3, shift (q & 7) 4)
    against the plain version."""
    w = grid_channels(n, n + 1, tiles=False)["gate"]
    got = gc.unpack_mirror(w, n)
    assert np.array_equal(got, gc.unpack_density_plain(torch.from_numpy(w),
                                                       n).numpy())


@pytest.mark.parametrize("axis,flip", AXIS_FLIP)
def test_slabs_mirror_matches_plain_and_jax(axis, flip):
    """X.8's mirror (rows of 16-byte quads, or of voxels, kSlabItems a
    thread, when the marching axis is x or y; the 32x32 (k, y) tile of two
    slabs x through shared memory when it is z; masked edges) against the
    plain stack and JAX's, bit for bit: contiguous volumes at 8-128^3 (mip
    sizes below a tile, an odd size, grids that are not a multiple of the
    tile, the two slabs of a block or a thread's items), for axis z also
    132^3 (quads whose last tiles are cut at every edge), and a strided
    density (the alpha of an rgba grid, read in place)."""
    rng = np.random.default_rng(10 + axis * 2 + flip)
    for n in (8, 13, 16, 40, 64, 128) + ((132,) if axis == 2 else ()):
        d = torch.from_numpy(rng.random((n, n, n), dtype=F32))
        lt = torch.from_numpy(rng.random((n, n, n), dtype=F32))
        vols = [(t.reshape(-1).numpy(), 0, gc._slab_strides(t, axis))
                for t in (d, lt)]
        got = gc.slabs_mirror(vols, n, axis, flip)
        want = gc.slabs_plain(d, lt, axis, flip).numpy()
        assert np.array_equal(got, want)
        if n <= 64:
            assert np.array_equal(got, _jax_slabs(d.numpy(), lt.numpy(), axis,
                                                  flip))
    n = 40
    rgba = torch.from_numpy(rng.random((n, n, n, 4), dtype=F32))
    dens, lt = rgba[..., 3], torch.from_numpy(rng.random((n, n, n), dtype=F32))
    vols = [(rgba.reshape(-1).numpy(), 3, gc._slab_strides(dens, axis)),
            (lt.reshape(-1).numpy(), 0, gc._slab_strides(lt, axis))]
    assert np.array_equal(gc.slabs_mirror(vols, n, axis, flip),
                          gc.slabs_plain(dens, lt, axis, flip).numpy())


@pytest.mark.parametrize("axis,flip", AXIS_FLIP)
@pytest.mark.parametrize("n", [8, 13, 33, 64])
def test_slabs_mirror_strided_and_unaligned(axis, flip, n):
    """X.8's mirror on the inputs its 16-byte paths refuse, against the
    plain stack and JAX's, bit for bit: the strided alpha of an rgba grid
    as density (element stride 4) beside a contiguous light, and two
    volumes one float past a 16-byte boundary (each a voxel path)."""
    rng = np.random.default_rng(100 + n * 6 + axis * 2 + flip)
    rgba = torch.from_numpy(rng.random((n, n, n, 4), dtype=F32))
    lt = torch.from_numpy(rng.random((n, n, n), dtype=F32))
    dens = rgba[..., 3]
    vols = [(rgba.reshape(-1).numpy(), 3, gc._slab_strides(dens, axis)),
            (lt.reshape(-1).numpy(), 0, gc._slab_strides(lt, axis))]
    want = gc.slabs_plain(dens, lt, axis, flip).numpy()
    assert np.array_equal(gc.slabs_mirror(vols, n, axis, flip), want)
    assert np.array_equal(want, _jax_slabs(dens.numpy(), lt.numpy(), axis,
                                           flip))
    flat = torch.from_numpy(rng.random(2 * n ** 3 + 2, dtype=F32))
    d1 = flat[1:1 + n ** 3].view(n, n, n)
    l1 = flat[n ** 3 + 2:].view(n, n, n)
    vols = [(flat.numpy(), 1, gc._slab_strides(d1, axis)),
            (flat.numpy(), n ** 3 + 2, gc._slab_strides(l1, axis))]
    assert np.array_equal(gc.slabs_mirror(vols, n, axis, flip),
                          gc.slabs_plain(d1, l1, axis, flip).numpy())


def test_slab_paths():
    """X.8's path by layout: the marching axis x or y copies rows, z
    transposes; 16-byte quads where n % 4 == 0 and the quads are
    contiguous and aligned, else single voxels (the strided alpha, an
    offset view, n = 13); the blocks each path gives a channel."""
    want = {  # (axis, layout) -> path at n = 64, and at n = 13
        (0, "contiguous"): (gc.ROWS_QUAD, gc.ROWS_VOXEL),
        (1, "contiguous"): (gc.ROWS_QUAD, gc.ROWS_VOXEL),
        (2, "contiguous"): (gc.TRANS_QUAD, gc.TRANS_VOXEL),
        (0, "alpha"): (gc.ROWS_VOXEL, gc.ROWS_VOXEL),
        (1, "alpha"): (gc.ROWS_VOXEL, gc.ROWS_VOXEL),
        (2, "alpha"): (gc.TRANS_VOXEL, gc.TRANS_VOXEL),
        (0, "offset"): (gc.ROWS_VOXEL, gc.ROWS_VOXEL),
        (2, "offset"): (gc.TRANS_VOXEL, gc.TRANS_VOXEL),
    }
    for (axis, layout), paths in want.items():
        for n, path in zip((64, 13), paths):
            vol = torch.zeros((n, n, n, 4))[..., 3] if layout == "alpha" else (
                torch.zeros(n ** 3 + 1)[1:].view(n, n, n)
                if layout == "offset" else torch.zeros((n, n, n)))
            off = vol.storage_offset() % 4
            assert gc.slab_path(off, gc._slab_strides(vol, axis), n) == path
    per_block = gc.SLAB_THREADS * gc.SLAB_ITEMS
    assert gc.slab_blocks(gc.ROWS_QUAD, 256) == 256 * 256 * 64 // per_block
    assert gc.slab_blocks(gc.ROWS_VOXEL, 13) == -(-13 ** 3 // per_block)
    assert gc.slab_blocks(gc.TRANS_QUAD, 256) == (256 // gc.SLAB_TILE_K) * (
        256 // gc.SLAB_TILE_Y) * (256 // gc.SLAB_TILE_X)
    assert gc.slab_blocks(gc.TRANS_VOXEL, 13) == -(-13 // gc.SLAB_TILE_X)


# ---- routing ---------------------------------------------------------------

def _launches():
    return [k.launches for k in (gc.UNTILE, gc.UNPACK, gc.SLABS)]


def test_cpu_and_use_kernel_false_take_the_plain_versions():
    """A CPU tensor takes each plain version; ``use_kernel=False`` does on a
    tensor that is not on the CPU (here a meta tensor), while with the kernel
    asked for the same tensor goes to the kernel and raises: no fallback."""
    before = _launches()
    n = 32
    d = grid_channels(n, 2)
    tids = torch.from_numpy(d["tids"])
    tiles = (tids, gc.tile_slots(tids, n))
    gc.untile(torch.from_numpy(d["ns"]), n, tiles=tiles)
    gc.unpack_density(torch.from_numpy(d["gate"]), n)
    vol = torch.zeros((n, n, n))
    gc.slabs(vol, vol, 2, True)
    assert _launches() == before
    meta = {"ns": torch.empty((len(d["tids"]), 128, 4), device="meta"),
            "tids": torch.empty(len(d["tids"]), dtype=torch.int64, device="meta"),
            "slots": torch.empty(n ** 3 // 128, dtype=torch.int32, device="meta"),
            "words": torch.empty((n, n, n // 32), dtype=torch.int32, device="meta"),
            "vol": torch.empty((n, n, n), device="meta")}
    mt = (meta["tids"], meta["slots"])
    grid_order = meta["vol"].reshape(-1, 1).expand(-1, 4)
    calls = [
        lambda **k: gc.untile(meta["ns"], n, tiles=mt, **k),
        lambda **k: gc.untile(meta["ns"], n, tiles=mt, gate=meta["words"], **k),
        lambda **k: gc.unpack_density(meta["words"], n, **k),
        lambda **k: gc.slabs(meta["vol"], meta["vol"], 0, False, **k),
    ]
    for call in calls:
        out = call(use_kernel=False)
        first = out[0] if isinstance(out, tuple) else out
        assert first.device.type == "meta"
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            call()
    # the grid-order form has no kernel: its plain version under the flag,
    # and a tensor off the CPU raises (the card's route is X.10)
    assert gc.untile(grid_order, n, use_kernel=False)[0].device.type == "meta"
    with pytest.raises(ValueError, match="grid-order form has no kernel"):
        gc.untile(grid_order, n)
    assert _launches() == before


@pytest.mark.parametrize("failure", ["build", "launch"])
def test_a_kernel_that_fails_raises(monkeypatch, failure):
    """With the checks of a CUDA tensor passed, a library that fails to build
    or an entry point that returns a CUDA error raises; nothing falls back
    and no launch is counted."""
    class Lib:
        def __getattr__(self, name):
            return lambda *a: 700  # cudaErrorIllegalAddress

    def load():
        if failure == "build":
            raise RuntimeError("nvcc not found: the CUDA toolkit is required")
        return Lib()

    monkeypatch.setattr(_cuda, "require", lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "load", load)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda dev: 0)
    n = 32
    meta_w = torch.empty((n, n, n // 32), dtype=torch.int32, device="meta")
    vol = torch.empty((n, n, n), device="meta")
    slots = torch.empty(n ** 3 // 128, dtype=torch.int32, device="meta")
    before = _launches()
    for call in (lambda: gc.untile(None, n, tiles=(slots, slots)),
                 lambda: gc.unpack_density(meta_w, n),
                 lambda: gc.slabs(vol, vol, 1, True)):
        with pytest.raises(RuntimeError, match="nvcc|CUDA error 700"):
            call()
    assert _launches() == before


def test_grid_sizes_the_kernels_refuse():
    """Words need n % 32 == 0 and tiles n % 8 == 0: the wrappers raise
    before a launch."""
    meta = torch.empty(1, device="meta")
    with pytest.raises(ValueError, match="n % 32"):
        gc.unpack_density(torch.empty((48, 48, 1), dtype=torch.int32,
                                      device="meta"), 48)
    with pytest.raises(ValueError, match="n % 8"):
        gc.untile(None, 20, tiles=(meta, meta))
    with pytest.raises(ValueError, match="n % 32"):
        gc.untile(None, 16, tiles=(meta, torch.empty(32, dtype=torch.int32,
                                                    device="meta")))


def test_voxel_grid_density_routes():
    """``VoxelGrid.density``: the kernel's density where X.6 wrote one (and
    ``use_kernel=False`` ignores it: rgba[..., 3]), ``rgba[..., 3]``
    otherwise, and without rgba the words through X.7's wrapper with the
    flag."""
    n = 32
    w = torch.from_numpy(grid_channels(n, 4, tiles=False)["gate"])
    rgba = torch.rand((n, n, n, 4))
    dens = torch.rand((n, n, n))
    g = VoxelGrid(words=w, rgba=rgba, dens=dens)
    assert g.density() is dens
    assert torch.equal(g.density(use_kernel=False), rgba[..., 3])
    assert torch.equal(VoxelGrid(words=w, rgba=rgba).density(), rgba[..., 3])
    assert torch.equal(VoxelGrid(words=w).density(),
                       unpack_bits_z(w, n).to(torch.float32))


def test_render_and_march_inputs_pass_use_kernels(monkeypatch):
    """``render(..., use_kernels=False)`` (the benchmark's plain image)
    recomputes the density and the slabs by the plain versions: the flag
    reaches ``VoxelGrid.density`` and X.8's wrapper; by default both are
    asked for the kernels."""
    from dxrvoxelizer_tpu_torch.models.camera import OrbitCamera
    from dxrvoxelizer_tpu_torch.models.scene import Scene
    from dxrvoxelizer_tpu_torch.utils.config import VoxelizerConfig
    from dxrvoxelizer_tpu_torch.utils.objloader import ObjMesh

    seen = []
    slabs0, unpack0 = gc.slabs, gc.unpack_density

    def slabs(*a, **kw):
        seen.append(("slabs", kw.get("use_kernel", True)))
        return slabs0(*a, **kw)

    def unpack(*a, **kw):
        seen.append(("unpack", kw.get("use_kernel", True)))
        return unpack0(*a, **kw)

    monkeypatch.setattr(gc, "slabs", slabs)
    monkeypatch.setattr(gc, "unpack_density", unpack)
    v, nr, t = icosphere_mesh(2)
    mesh = ObjMesh(positions=v, normals=nr, indices=t.reshape(-1),
                   aabb_min=v.min(0), aabb_max=v.max(0))
    cfg = VoxelizerConfig(grid_size=32, width=48, height=32)
    scene = Scene(mesh, "cpu")
    cam = OrbitCamera(cfg.width, cfg.height)
    fc = scene.update_frame(cam.eye, cam.view_proj, cfg.width, cfg.height)
    grid = pipeline.voxelize(scene.buffers, 32)
    imgs = {}
    for use in (True, False):
        seen.clear()
        imgs[use] = pipeline.render(grid, fc, cfg, use_kernels=use)
        assert seen == [("unpack", use), ("slabs", use)]
    assert torch.equal(imgs[True], imgs[False])


@pytest.mark.parametrize("gen", [6, 7])
def test_voxelize_through_x6_equals_the_old_chain(gen):
    """``voxelize(mode="raystab", accel=gen-6 or gen-7)`` goes through X.6's
    wrapper (its plain version here) and gives what the query, then
    ``quantize_r10g10b10a2`` and ``pack_bits_z`` gave, rounded or not; the
    ``-normals`` grid (X.6's gated form) what the gating chain gave."""
    from dxrvoxelizer_tpu_torch.models.mesh import MeshBuffers

    v, nr, t = icosphere_mesh(2)
    vt, nt_, tt = (torch.from_numpy(np.asarray(v, F32)),
                   torch.from_numpy(np.asarray(nr, F32)),
                   torch.from_numpy(np.asarray(t, np.int64)))
    mesh = MeshBuffers(positions=vt, normals=nt_, tris=tt, positions_norm=vt)
    n = 32
    build = rt.build_raystab_accel7 if gen == 7 else rf.build_raystab_accel2
    accel = build(vt, tt, nt_, n=n)
    query = rt.raystab_query7 if gen == 7 else rf.raystab_query2
    grid_fn = rt.raystab_grid7 if gen == 7 else rf.raystab_grid2
    for q in (False, True):
        occ, rgba = query(accel)
        want = quantize_r10g10b10a2(rgba) if q else rgba
        got_rgba, got_w, dens = grid_fn(accel, quantize=q)
        assert dens is None
        assert torch.equal(got_w, pack_bits_z(occ))
        assert np.array_equal(_bits(got_rgba.numpy()), _bits(want.numpy()))
        g = pipeline.voxelize(mesh, n, mode="raystab", accel=accel, quantize=q)
        assert torch.equal(g.words, got_w) and torch.equal(g.rgba, got_rgba)
        words = pack_bits_z(occ)
        _, hit = query(accel, rule="hit")
        occ_f = unpack_bits_z(words, n).to(torch.float32)[..., None]
        gated = torch.cat([hit[..., :3] * occ_f, occ_f], dim=-1)
        gated = quantize_r10g10b10a2(gated) if q else gated
        got = grid_fn(accel, rule="hit", quantize=q, gate=words)
        assert got[1] is None
        assert np.array_equal(_bits(got[0].numpy()), _bits(gated.numpy()))


# ---- X.10: gen-6's stream merge ----------------------------------------------

@pytest.fixture(scope="module")
def gen6():
    """A 64^3 gen-6 accel with both streams (a 320-triangle icosphere and 40
    near-origin triangles) and its streams' fold outputs."""
    v, nr, t = icosphere_mesh(2)
    rng = np.random.default_rng(11)
    soup = (rng.standard_normal((40, 1, 3)) * 0.02
            + rng.standard_normal((40, 3, 3)) * 0.3).astype(F32)
    v = np.concatenate([v, soup.reshape(-1, 3)])
    nr = np.concatenate([nr, rng.standard_normal((120, 3)).astype(F32)])
    t = np.concatenate([t, np.arange(120).reshape(-1, 3) + len(v) - 120])
    accel = rf.build_raystab_accel2(torch.from_numpy(v),
                                    torch.from_numpy(t.astype(np.int64)),
                                    torch.from_numpy(nr), n=64)
    assert accel.main is not None and accel.ov is not None
    return accel, rf._stream_outs2(accel, rf.INSIDE_THRESHOLD, "hit")


def _tie_outs(outs, seed=3):
    """Stream outputs shaped as ``outs`` whose t come from {0.5, 1, +inf}
    and ids from 0..4, so that the near-origin stream ties the main one in
    t under lower, equal and higher ids; channels from the tie set."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, (t, i, ns) in outs.items():
        tt = rng.choice(np.array([0.5, 1.0, np.inf], F32), t.shape)
        ii = rng.integers(0, 5, i.shape).astype(np.int32)
        ch = rng.choice(quantize_cases(), ns.shape).astype(F32)
        out[k] = tuple(torch.from_numpy(a) for a in (tt, ii, ch))
    return out


def test_ray_slot_map_is_the_inverse_of_slot_ray(gen6):
    """``ray_slot[r]`` is the slot whose ray is r, -1 for a ray no strip
    covers; a refit carries the rest build's map."""
    accel, _ = gen6
    v = accel.n ** 3
    sr = accel.slot_ray.numpy()
    want = np.full(v, -1, np.int64)
    real = sr < v
    want[sr[real]] = np.nonzero(real)[0]
    assert accel.ray_slot.dtype == torch.int32
    assert np.array_equal(accel.ray_slot.numpy(), want)
    assert np.unique(sr[real]).size == real.sum()  # a ray in one slot at most


@pytest.mark.parametrize("case", ["fold", "ties", "main only", "packed"])
def test_merge_mirror_matches_plain(monkeypatch, gen6, case):
    """X.10's mirror (ray v's slot through the map, then the near-origin
    lane v where its t is smaller or equal with a lower id; X.6's tail)
    against ``_merge_streams2`` + ``untile_plain`` with the card's
    division, rounded and not, gated and not, bit for bit: on the fold's
    outputs, on outputs full of t ties, without the near-origin stream and
    on the sharded frames' packed pieces (strided views)."""
    _card_division(monkeypatch)
    accel, outs = gen6
    n = accel.n
    outs = {"fold": outs, "ties": _tie_outs(outs),
            "main only": {"main": outs["main"]},
            "packed": packed_outs(outs)}[case]
    gate = grid_channels(n, 7, tiles=False)["gate"]
    np_outs = {k: tuple(a.numpy() for a in o) for k, o in outs.items()}
    for q in (False, True):
        for g in (None, gate):
            got = gc.merge(accel, outs, gate=None if g is None else
                           torch.from_numpy(g), quantize=q)
            assert got[2] is None
            m = gc.merge_mirror(n, accel.ray_slot.numpy(), np_outs["main"],
                                np_outs.get("ov"), g, q)
            same = _same if q else (lambda a, b: np.array_equal(_bits(a),
                                                                _bits(b)))
            assert same(m[0], got[0].numpy())
            assert same(m[2], got[0].numpy()[..., 3])
            assert (m[1] is None) == (got[1] is None) == (g is not None)
            if m[1] is not None:
                assert np.array_equal(m[1], got[1].numpy())


def _merge_launches():
    return [k.launches for k in (gc.MERGE, gc.UNTILE)]


def test_merge_routes_and_raises(gen6):
    """A CPU tensor and ``use_kernel=False`` take the plain version (no
    launch); the same outputs on a device that is not the CPU go to the
    kernel, which refuses them: no fallback."""
    import types

    accel, outs = gen6
    before = _merge_launches()
    gc.merge(accel, outs)
    assert _merge_launches() == before
    meta = types.SimpleNamespace(
        n=64, device=torch.device("meta"),
        ray_slot=torch.empty(64 ** 3, dtype=torch.int32, device="meta"),
        slot_ray=accel.slot_ray.to("meta"))
    mouts = {k: tuple(a.to("meta") for a in o) for k, o in outs.items()}
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        gc.merge(meta, mouts)
    with pytest.raises(ValueError, match="n % 32"):
        gc.merge(types.SimpleNamespace(n=48, device=torch.device("meta")), {})
    assert _merge_launches() == before


@pytest.mark.parametrize("failure", ["build", "launch", "stride"])
def test_a_merge_that_fails_raises(monkeypatch, gen6, failure):
    """A library that fails to build, an entry point that returns a CUDA
    error, or outputs whose entries are not one stride apart raise; no
    launch is counted."""
    import types

    class Lib:
        def __getattr__(self, name):
            return lambda *a: 700  # cudaErrorIllegalAddress

    def load():
        if failure == "build":
            raise RuntimeError("nvcc not found: the CUDA toolkit is required")
        return Lib()

    accel, outs = gen6
    outs = {k: tuple(a.to("meta") for a in o) for k, o in outs.items()}
    if failure == "stride":  # every other strip: not one stride apart
        outs = {k: tuple(a[::2] for a in o) for k, o in outs.items()}
    monkeypatch.setattr(_cuda, "require", lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "load", load)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda dev: 0)
    card = types.SimpleNamespace(n=accel.n, device=torch.device("meta"),
                                 ray_slot=accel.ray_slot.to("meta"),
                                 slot_ray=accel.slot_ray[::2])
    before = _merge_launches()
    err = (ValueError, "stride") if failure == "stride" else (
        RuntimeError, "nvcc|CUDA error 700")
    with pytest.raises(err[0], match=err[1]):
        gc.merge(card, outs)
    assert _merge_launches() == before


def test_card_routes_reach_no_plain_chain(monkeypatch):
    """The card's routes rehearsed on CPU tensors (``MeshBuffers.device``
    reports "cuda" in FramePipeline's frames, as the benchmark's tests
    rehearse it): the refits, the gen-6 and gen-7 queries and grids, the
    ``-inside raystab`` and ``-normals`` frames, and every sharded frame,
    query and merge (world 2: gen-6 and gen-7, static and deforming, the
    parity frames) call the wrappers of X.9, X.10, X.6 and X.7, and reach
    ``_fused_coef_matrix``, ``_merge_streams2``, ``untile7``,
    ``_stab_density`` and ``unpack_bits_z`` only inside a wrapper (its plain
    version, which a CUDA tensor never takes)."""
    import dataclasses

    from dxrvoxelizer_tpu_torch.app.main import wobbled
    from dxrvoxelizer_tpu_torch.models.camera import OrbitCamera
    from dxrvoxelizer_tpu_torch.models.mesh import MeshBuffers
    from dxrvoxelizer_tpu_torch.models.scene import Scene
    from dxrvoxelizer_tpu_torch.ops import raystab_refit
    from dxrvoxelizer_tpu_torch.parallel import (
        ShardedFramePipeline,
        make_local_group,
        sharded_frame,
    )
    from dxrvoxelizer_tpu_torch.parallel import raystab_shard as rs
    from dxrvoxelizer_tpu_torch.parallel import shard
    from dxrvoxelizer_tpu_torch.utils.config import VoxelizerConfig
    from dxrvoxelizer_tpu_torch.utils.objloader import ObjMesh

    depth, called = [0], set()

    def wrapper(mod, name):
        fn = getattr(mod, name)

        def spy(*a, **k):
            called.add(name)
            depth[0] += 1
            try:
                return fn(*a, **k)
            finally:
                depth[0] -= 1
        return spy

    def guarded(fn, name):
        def f(*a, **k):
            assert depth[0] > 0, f"{name} reached outside a kernel's wrapper"
            return fn(*a, **k)
        return f

    fused = wrapper(rf, "fused_coef_matrix")
    for mod in (rf, raystab_refit, rt):
        monkeypatch.setattr(mod, "fused_coef_matrix", fused)
    for name in ("merge", "untile", "unpack_density"):
        monkeypatch.setattr(gc, name, wrapper(gc, name))
    for mod, name in ((rf, "_fused_coef_matrix"), (rf, "_merge_streams2"),
                      (rt, "untile7"), (rs, "_stab_density"),
                      (gc, "unpack_bits_z"), (shard, "unpack_bits_z"),
                      (rs, "unpack_bits_z")):
        if hasattr(mod, name):
            monkeypatch.setattr(mod, name, guarded(getattr(mod, name), name))
    inside = [0]
    real = MeshBuffers.device
    monkeypatch.setattr(MeshBuffers, "device", property(
        lambda self: torch.device("cuda") if inside[0] else real.fget(self)))
    frame0 = pipeline.FramePipeline.frame

    def frame(self, consts):
        inside[0] += 1
        try:
            return frame0(self, consts)
        finally:
            inside[0] -= 1

    class Event:
        def record(self):
            pass

        def synchronize(self):
            pass

    monkeypatch.setattr(pipeline.FramePipeline, "frame", frame)
    monkeypatch.setattr(torch.cuda, "Event", Event)

    v, nrm, t = icosphere_mesh(2, radius=0.6)
    v = np.asarray(v, F32) * 2.0 + np.array([0, 4, 0], F32)
    scene = Scene(ObjMesh(positions=v, normals=np.asarray(nrm, F32),
                          indices=np.asarray(t, np.int32).reshape(-1),
                          aabb_min=v.min(0), aabb_max=v.max(0)), "cpu")
    mb = scene.buffers
    moved = wobbled(mb, mb.positions_norm[:, :1].numpy(), 3)
    kw = dict(grid_size=32, width=48, height=32, accel_cache=False)
    cam = OrbitCamera(48, 32)
    consts = scene.update_frame(cam.eye, cam.view_proj, 48, 32)
    args = (np.asarray(consts.screen_to_local, F32),
            np.asarray(consts.local_space_eye_pt, F32),
            np.asarray(consts.local_space_light_pt, F32),
            np.zeros(3, F32))
    # the single-device frames: -inside raystab (gen-6 on a card), -normals
    for cfg_kw in (dict(inside_mode="raystab"), dict(parity_normals=True)):
        pipeline.FramePipeline(VoxelizerConfig(**kw, **cfg_kw), mb).frame(consts)
    assert {"merge", "fused_coef_matrix"} <= called
    for gen in ("6", "7"):
        monkeypatch.setenv("DXRV_RAYSTAB_GEN", gen)
        cfg = VoxelizerConfig(**kw, inside_mode="raystab")
        for deforming in (False, True):
            p = ShardedFramePipeline(cfg, mb, 2, deforming=deforming,
                                     group=make_local_group(2, "cpu"))
            if deforming:
                p.mesh = moved
            p.frame(consts)
            accel = p.refitter.refit(moved.positions_norm, moved.normals) \
                if deforming else p.accel
            query = (rs.raystab_query7_sharded if gen == "7"
                     else rs.raystab_query2_sharded)
            query(None, None, None, accel, make_local_group(2, "cpu"))
            grid = (rt.raystab_grid7 if gen == "7" else rf.raystab_grid2)
            grid(accel)
            (rt.raystab_query7 if gen == "7" else rf.raystab_query2)(accel)
    monkeypatch.delenv("DXRV_RAYSTAB_GEN")
    ShardedFramePipeline(VoxelizerConfig(**kw), mb, 2,
                         group=make_local_group(2, "cpu")).frame(consts)
    sharded_frame(make_local_group(2, "cpu"), 32, 48, 32)(
        mb.positions_norm, mb.tris, *args)
    assert called == {"fused_coef_matrix", "merge", "untile", "unpack_density"}


@pytest.mark.parametrize("gen", [6, 7])
def test_sharded_merge_equals_the_old_chain(gen):
    """``merge_pieces`` on the gathered pieces of world 1 and 2, on CPU
    tensors: the query form equals the old chain (``untile7`` or
    ``_merge_streams2``) and the frame's grid its rounding, its density
    ``_stab_density`` of the old chain's rgba, bit for bit."""
    from dxrvoxelizer_tpu_torch.parallel import raystab_shard as rs

    v, nr, t = (torch.from_numpy(np.asarray(a)) for a in icosphere_mesh(2))
    t = t.long()
    n = 32
    build = rt.build_raystab_accel7 if gen == 7 else rf.build_raystab_accel2
    accel = build(v, t, nr, n=n)
    if gen == 7:
        _, old = rt.untile7(accel, rt._fold7(accel, rf.INSIDE_THRESHOLD,
                                             "backface", True))
    else:
        old = rf._merge_streams2(accel, rf._stream_outs2(
            accel, rf.INSIDE_THRESHOLD, "backface")).reshape(n, n, n, 4)
    for world in (1, 2):
        gathered = torch.cat([rs.stream_piece(accel, world, r,
                                              rf.INSIDE_THRESHOLD, "backface")
                              for r in range(world)])
        occ, rgba = rs.merge_pieces(accel, gathered, world)
        assert np.array_equal(_bits(rgba.numpy()), _bits(old.numpy()))
        assert torch.equal(occ, old[..., 3] != 0.0)
        grid = rs.merge_pieces(accel, gathered, world, grid=True)
        assert grid[1] is None
        assert np.array_equal(_bits(grid[0].numpy()),
                              _bits(quantize_r10g10b10a2(old).numpy()))
        assert torch.equal(rs._grid_density(grid), rs._stab_density(old))
