"""The light recurrences of the warp render (ops/raymarch_warp.py
``light_sweep_ref``, the ``-hq`` reference-step sweep X.3,
``light_sweep``, the ``-fast`` per-slab sweep X.4, and
``light_sweep_point``, the ``-pointlight`` perspective sweep X.5) on the
CPU.

Their CUDA kernel (csrc/light_sweep.cu) runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py). Here a numpy mirror of the
kernel's index arithmetic (the natural [N, N, N] layout read through the
slab order's strides and reflection, reversed slab r reading r-d0 and
r-d0-1 of its own output, the clamped density taps, the host's box of
texels inside the volume; X.5's per-slab tap maps and per-tap crossing
lengths in the kernel's rounding order) is held against the plain versions
within 1e-6, slab by slab and in the kernel's schedule: its blocks, each
running its steps as soon as the blocks it found as its producers have
posted theirs (X.5: a range found anew every step), so that a producer
range that missed a writer reads a slab before it is written. The producer
ranges are checked without a volume at 256^3 too, and the launch's block
size (``sweep_threads``) by its choices. The plain versions are held
against the JAX package by
tests/test_torch_render.py::test_light_sweeps_match_jax and (X.5)
tests/test_torch_render_variants.py on the same lights; X.5's mirror is
held against JAX here too, at 160^3.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dxrvoxelizer_tpu_torch.core import pipeline
from dxrvoxelizer_tpu_torch.ops import raymarch_warp as rw
from dxrvoxelizer_tpu_torch.ops.raymarch_ref import ABSORPTION
from tests.test_torch_render import LIGHTS
from tests.torch_cases import (
    POINT_KINDS,
    SWEEP_LIGHTS,
    cell_light,
    d0_light,
    point_light,
    point_lights,
)

torch.set_num_threads(2)

F32 = np.float32
ALL_LIGHTS = LIGHTS + SWEEP_LIGHTS
TOL_MIRROR = 1e-6


def _density(n, seed=11, p=0.2):
    rng = np.random.default_rng(seed)
    return ((rng.random((n, n, n)) < p) * rng.random((n, n, n))).astype(F32)


def test_sweep_lights_cover_every_axis_flip_and_window():
    """The lights give every major tex axis and flip with d0 = 2 and 3 at
    64^3 and d0 = 1 at 32^3 (the reference step), and every axis and flip
    for the per-slab sweep."""
    at64 = {rw.light_ref_statics(np.asarray(lt, F32), 64) for lt in ALL_LIGHTS}
    assert at64 == {(a, f, d) for a in range(3) for f in (False, True)
                    for d in (2, 3)}
    at32 = {rw.light_ref_statics(np.asarray(lt, F32), 32) for lt in ALL_LIGHTS}
    assert at32 == {(a, f, 1) for a in range(3) for f in (False, True)}
    fast = {rw.light_statics(np.asarray(lt, F32)) for lt in ALL_LIGHTS}
    assert fast == {(a, f) for a in range(3) for f in (False, True)}


# ---- the kernel's index arithmetic, in numpy --------------------------------

def _layout(n, axis, flip):
    """The kernel's strides: slab k's offset, slab x's and slab y's."""
    stride = (n * n, n, 1)
    rest = [a for a in range(3) if a != axis]

    def slab(k):
        return (n - 1 - k if flip else k) * stride[axis]

    return slab, stride[rest[0]], stride[rest[1]]


def _taps(c, n):
    """csrc/light_sweep.cu axis_taps: (i0, in0, in1, w0, w1)."""
    c0 = np.floor(c)
    f = (c - c0).astype(F32)
    i0 = c0.astype(np.int64)
    in0 = (i0 >= 0) & (i0 <= n - 1)
    in1 = (i0 + 1 >= 0) & (i0 + 1 <= n - 1)
    return (i0, in0, in1, np.where(in0, F32(1) - f, F32(0)),
            np.where(in1, f, F32(0)))


def _row_sum(t):
    return t[3] + t[4]


def _resample(tx, ty, value, n):
    """x taps, then y taps; value(ix, iy) read only for taps inside."""
    xi0, xin0, xin1, xw0, xw1 = tx
    yi0, yin0, yin1, yw0, yw1 = ty
    rows = []
    for yi, yin in ((yi0, yin0), (yi0 + 1, yin1)):
        def at(xi, xin):
            v = value(np.clip(xi, 0, n - 1), np.clip(yi, 0, n - 1))
            return np.where(yin & xin, v, F32(0))

        rows.append(xw0 * at(xi0, xin0) + xw1 * at(xi0 + 1, xin1))
    return yw0 * rows[0] + yw1 * rows[1]


def _attenuation(d, absl):
    g = np.minimum(d * F32(8), F32(16))
    return np.clip(F32(1) - F32(absl) * g, F32(0), F32(1))


def mirror_ref(dens: np.ndarray, light, n_light: int = 32) -> np.ndarray:
    """X.3 as the kernel computes it, block by block of d0 slabs."""
    n = dens.shape[0]
    axis, flip, d0 = rw.light_ref_statics(np.asarray(light, F32), n, n_light)
    st = rw.ref_statics(rw._light_key(light), n, axis, flip, d0, n_light)
    slab, sx, sy = _layout(n, axis, flip)
    flat, out = dens.reshape(-1), np.full(n ** 3, np.nan, F32)
    x, y = np.arange(n)[:, None], np.arange(n)[None, :]
    xlo, xhi, ylo, yhi, kmax = st.box
    inside = (x >= xlo) & (x <= xhi) & (y >= ylo) & (y <= yhi)
    w = F32(st.w)
    omw = F32(1) - w
    cx = x.astype(F32) + F32(st.shift[0])
    cy = y.astype(F32) + F32(st.shift[1])
    top = F32(n - 1)
    dx, dy = _taps(np.clip(cx, 0, top), n), _taps(np.clip(cy, 0, top), n)
    lx, ly = _taps(cx, n), _taps(cy, n)
    corr = F32(1) - _row_sum(lx) * _row_sum(ly)
    nb = -(-n // d0)
    for b in range(nb):
        for r in range(b * d0, min((b + 1) * d0, n)):
            k = n - 1 - r
            here = slab(k) + x * sx + y * sy
            if k > kmax:
                out[here] = 1.0
                continue
            z0, z1 = slab(min(k + d0, n - 1)), slab(min(k + d0 + 1, n - 1))

            def dval(i, j):
                o = i * sx + j * sy
                return flat[z0 + o] * omw + flat[z1 + o] * w

            att = _attenuation(_resample(dx, dy, dval, n), st.absl)
            # slabs r-d0 and r-d0-1: written by an earlier block, or 1
            assert r - d0 < b * d0
            la = slab(k + d0) if r - d0 >= 0 else None
            lb = slab(k + d0 + 1) if r - d0 - 1 >= 0 else None

            def lval(i, j):
                o = i * sx + j * sy
                a = out[la + o] if la is not None else F32(1)
                c = out[lb + o] if lb is not None else F32(1)
                return a * omw + c * w

            lres = _resample(lx, ly, lval, n)
            out[here] = np.where(inside, att * (lres + corr), F32(1))
    assert not np.isnan(out).any()
    return out.reshape(n, n, n)


def mirror_dir(dens: np.ndarray, light) -> np.ndarray:
    """X.4 as the kernel computes it, slab by slab."""
    n = dens.shape[0]
    axis, flip = rw.light_statics(np.asarray(light, F32))
    shift_x, shift_y, absl = rw._dir_statics(rw._light_key(light), n, axis,
                                             flip)
    slab, sx, sy = _layout(n, axis, flip)
    flat, out = dens.reshape(-1), np.full(n ** 3, np.nan, F32)
    x, y = np.arange(n)[:, None], np.arange(n)[None, :]
    ax = _taps(x.astype(F32) + F32(shift_x), n)
    ay = _taps(y.astype(F32) + F32(shift_y), n)
    omwsum = F32(1) - _row_sum(ax) * _row_sum(ay)
    for k in range(n - 1, -1, -1):
        def carry(i, j):
            if k == n - 1:  # past the far slab
                return np.ones(np.broadcast(i, j).shape, F32)
            o = slab(k + 1) + i * sx + j * sy
            return out[o] * _attenuation(flat[o], absl)

        out[slab(k) + x * sx + y * sy] = _resample(ax, ay, carry, n) + omwsum
    assert not np.isnan(out).any()
    return out.reshape(n, n, n)


def _point_statics(light, n):
    """(axis, flip, (l_x, l_y, l_z)) as light_sweep_point_host passes them
    to the kernel."""
    lt = np.asarray(light, F32)
    axis, flip, sweep = rw.point_light_statics(lt, n)
    assert sweep, light
    return axis, flip, rw._point_statics(rw._light_key(lt), axis, flip)


def _slab_z(k, n):
    """csrc/light_sweep.cu slab_z: (k + 0.5) / n, a rounded float32
    division."""
    return (np.asarray(k).astype(F32) + F32(0.5)) / F32(n)


def _point_slab(n, k, light):
    """csrc/light_sweep.cu point_slab: slab k's tap map (a, off_x, off_y)
    and the carry slab k+1's dz^2 and |dz|."""
    lx, ly, lz = (F32(v) for v in light)
    z1 = _slab_z(k + 1, n) if k + 1 < n else F32(n + 0.5) / F32(n)
    dz = z1 - lz
    a = dz / (_slab_z(k, n) - lz)
    oma = F32(1) - a
    nf = F32(n)
    return (a, (nf * lx) * oma - F32(0.5), (nf * ly) * oma - F32(0.5),
            dz * dz, np.abs(dz))


def _point_coord(a, off, i):
    """csrc/light_sweep.cu point_coord: a * (i + 0.5) + off."""
    return a * (np.asarray(i).astype(F32) + F32(0.5)) + off


def _point_voxels(out, flat, n, layout, light, k, x, y):
    """The kernel's point_voxel on arrays of voxels of slab k, reading slab
    k+1 of the field so far from ``out``: each carry tap times the
    attenuation at its own crossing length."""
    slab, sx, sy = layout
    lx, ly, _ = (F32(v) for v in light)
    a, off_x, off_y, dz2, adz = _point_slab(n, k, light)
    ax = _taps(_point_coord(a, off_x, x), n)
    ay = _taps(_point_coord(a, off_y, y), n)
    corr = F32(1) - _row_sum(ax) * _row_sum(ay)
    c2n = F32(2) / F32(n)

    def carry(i, j):
        if k == n - 1:  # past the far slab
            return np.ones(np.broadcast(i, j).shape, F32)
        o = slab(k + 1) + i * sx + j * sy
        dx, dy = _slab_z(i, n) - lx, _slab_z(j, n) - ly
        delta = (c2n * np.sqrt((dx * dx + dy * dy) + dz2)) / adz
        return out[o] * _attenuation(flat[o], F32(ABSORPTION) * delta)

    return _resample(ax, ay, carry, n) + corr


def mirror_point(dens: np.ndarray, light) -> np.ndarray:
    """X.5 as the kernel computes it, slab by slab."""
    n = dens.shape[0]
    axis, flip, lt = _point_statics(light, n)
    layout = _layout(n, axis, flip)
    slab, sx, sy = layout
    flat, out = dens.reshape(-1), np.full(n ** 3, np.nan, F32)
    x, y = np.arange(n)[:, None], np.arange(n)[None, :]
    for k in range(n - 1, -1, -1):
        out[slab(k) + x * sx + y * sy] = _point_voxels(out, flat, n, layout,
                                                       lt, k, x, y)
    assert not np.isnan(out).any()
    return out.reshape(n, n, n)


def test_point_constants_round_as_the_plain_version():
    """X.5's kernel rounds 2 / n and (n + 0.5) / n in float32 where the
    plain version rounds Python's float64 quotients to float32: the same
    values at every grid up to 4096."""
    for n in range(1, 4097):
        assert np.float32(2.0 / n) == F32(2) / F32(n), n
        assert np.float32((n + 0.5) / n) == F32(n + 0.5) / F32(n), n


def test_point_mirror_matches_jax_at_160(monkeypatch):
    """At 160^3 (n not a power of two) with the light near the far face,
    where an ulp of a slab centre moves a tap by 1e-3 texels: the kernel's
    mirror is within 1e-6 of the plain version and within 1e-5 of JAX's
    light_sweep_point run op by op, and the plain version does not depend
    on how the device divides by a Python scalar (PyTorch's CUDA division
    multiplies by the float32 reciprocal, emulated here; so does jitted
    XLA for a division by the constant n; that rounding moves the field by
    up to 3.3e-4)."""
    import jax
    import jax.numpy as jnp

    from dxrvoxelizer_tpu.ops import raymarch_warp as jrw

    n = 160
    dens = _density(n)
    light = point_light(0, 1.0, "near", n)
    axis, flip, _ = _point_statics(light, n)
    args = (torch.from_numpy(dens), np.asarray(light, F32), n, axis, flip)
    plain = rw.light_sweep_point_plain(*args).numpy()
    div = torch.Tensor.__truediv__

    def card_div(a, b):
        if isinstance(b, (int, float)) and a.dtype == torch.float32:
            return a * torch.tensor(F32(1) / F32(b))
        return div(a, b)

    monkeypatch.setattr(torch.Tensor, "__truediv__", card_div)
    card = rw.light_sweep_point_plain(*args).numpy()
    monkeypatch.undo()
    np.testing.assert_array_equal(card, plain)
    got = mirror_point(dens, light)
    np.testing.assert_allclose(got, plain, rtol=0, atol=TOL_MIRROR)
    with jax.disable_jit():
        want = np.asarray(jrw.light_sweep_point(
            jnp.asarray(dens), jnp.asarray(light, jnp.float32), n, axis,
            flip))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (want < 0.5).any()


# ---- the kernel's schedule (csrc/light_sweep.cu: blocks, producers) --------

def _voxel_at(n, per, minor_y, v):
    """csrc/light_sweep.cu voxel_at: a step's voxel ids -> (j, x, y), along
    slab y where it is the layout's minor axis (or X.4), else along the
    step's slabs."""
    if minor_y or per == 1:
        j, xy = np.divmod(v, n * n)
    else:
        xy, j = np.divmod(v, per)
    x, y = np.divmod(xy, n)
    return j, x, y


def _voxel_index(n, per, minor_y, j, x, y):
    """voxel_at's inverse."""
    xy = x * n + y
    return j * n * n + xy if (minor_y or per == 1) else xy * per + j


def _first_tap(x, shift):
    """The first tap of a texel's coordinate: floor of the float32
    x + shift."""
    return np.floor(np.asarray(x, F32) + F32(shift)).astype(np.int64)


def sweep_blocks(n, ref, d0, threads, resident):
    """csrc/light_sweep.cu launch: as many blocks of ``threads`` as a step's
    voxels need (a voxel a thread), at most ``resident`` (the card's
    occupancy) and 4,096 (its flags)."""
    need = -(-(d0 if ref else 1) * n * n // threads)
    return min(need, resident, rw.FLAGS_MAX)


def _tap_range(a, off, i0, i1, n):
    """csrc/light_sweep.cu tap_range: the taps coordinates a * (i + 0.5) +
    off read for i in i0..i1 (arrays), clipped to [0, n-1] (none: lo >
    hi)."""
    t0 = np.floor(_point_coord(a, off, i0)).astype(np.int64)
    t1 = np.floor(_point_coord(a, off, i1)).astype(np.int64)
    return (np.maximum(np.minimum(t0, t1), 0),
            np.minimum(np.maximum(t0, t1) + 1, n - 1))


def point_producers(n, chunk, blocks, slab_map):
    """csrc/light_sweep.cu point_producers for every block at one step
    (slab k's map ``slab_map`` = (a, off_x, off_y)): the run's end rows
    and columns under the map -> (lo, hi) per block (none: lo > hi)."""
    a, off_x, off_y = slab_map
    v0 = np.arange(blocks) * chunk
    v1 = np.minimum(n * n, v0 + chunk) - 1
    x0, x1 = v0 // n, v1 // n
    one = x0 == x1
    y0 = np.where(one, v0 - x0 * n, 0)
    y1 = np.where(one, v1 - x1 * n, n - 1)
    tx0, tx1 = _tap_range(a, off_x, x0, x1, n)
    ty0, ty1 = _tap_range(a, off_y, y0, y1, n)
    none = (v0 > v1) | (tx0 > tx1) | (ty0 > ty1)
    return (np.where(none, 1, (tx0 * n + ty0) // chunk),
            np.where(none, 0, (tx1 * n + ty1) // chunk))


class Schedule:
    """A field's launch as csrc/light_sweep.cu runs it: ``blocks`` blocks of
    ``threads``, block b holding voxels b*chunk .. (b+1)*chunk-1 of every
    step, and per step and block the range of its producers (``lo[s]``,
    ``hi[s]``: the blocks whose voxels its carry taps read; X.3 and X.4 find
    one range per launch, X.5, whose tap map changes with the slab
    (``point``: its light (l_x, l_y, l_z)), one a step)."""

    def __init__(self, n, ref, axis, flip, d0, shift, threads, resident,
                 point=None):
        self.n, self.ref, self.per = n, ref, (d0 if ref else 1)
        self.shift, self.point = shift, point
        self.count = self.per * n * n
        self.steps = -(-n // self.per)
        self.minor_y = _layout(n, axis, flip)[2] == 1
        self.blocks = sweep_blocks(n, ref, d0, threads, resident)
        self.chunk = -(-self.count // self.blocks)
        v = np.arange(self.count)
        self.owner = v // self.chunk
        self.jxy = _voxel_at(n, self.per, self.minor_y, v)
        if point is None:  # one tap map: the writers of every step
            self._writers = w = self._tap_writers(
                _first_tap(self.jxy[1], shift[0]),
                _first_tap(self.jxy[2], shift[1]))
            big = np.iinfo(np.int64).max
            lo, hi = np.full(self.blocks, big), np.full(self.blocks, -1)
            has = w >= 0
            np.minimum.at(lo, np.repeat(self.owner, has.sum(1)), w[has])
            np.maximum.at(hi, np.repeat(self.owner, has.sum(1)), w[has])
            self.lo = np.broadcast_to(lo, (self.steps, self.blocks))
            self.hi = np.broadcast_to(hi, (self.steps, self.blocks))
        else:
            ranges = [point_producers(n, self.chunk, self.blocks,
                                      _point_slab(n, n - 1 - s, point)[:3])
                      for s in range(self.steps)]
            self.lo = np.stack([r[0] for r in ranges])
            self.hi = np.stack([r[1] for r in ranges])

    def writers(self, s):
        """[voxels, taps]: the block writing each carry tap of step s (-1:
        none, the tap outside)."""
        if self.point is None:
            return self._writers
        n, (_, x, y) = self.n, self.jxy
        a, off_x, off_y = _point_slab(n, n - 1 - s, self.point)[:3]
        first = [np.floor(_point_coord(a, off, np.arange(n))).astype(np.int64)
                 for off in (off_x, off_y)]
        return self._tap_writers(first[0][x], first[1][y])

    def _tap_writers(self, ix, iy):
        """writers() from each voxel's first tap along slab x and y."""
        n, j = self.n, self.jxy[0]
        out = []
        for jq in ((j, np.where(j > 0, j - 1, self.per - 1)) if self.ref
                   else (np.zeros_like(j),)):
            for dx in (0, 1):
                for dy in (0, 1):
                    i, jj = ix + dx, iy + dy
                    inside = (i >= 0) & (i < n) & (jj >= 0) & (jj < n)
                    w = _voxel_index(n, self.per, self.minor_y, jq,
                                     np.clip(i, 0, n - 1),
                                     np.clip(jj, 0, n - 1))
                    out.append(np.where(inside, w // self.chunk, -1))
        return np.stack(out, axis=1)

    def covers(self) -> int:
        """Every tap's writer lies in its reader's producer range at every
        step that reads -> the taps checked."""
        checked = 0
        for s in (range(1, self.steps) if self.point is not None else (0,)):
            w = self.writers(s)
            lo, hi = self.lo[s][self.owner], self.hi[s][self.owner]
            ok = (w < 0) | ((w >= lo[:, None]) & (w <= hi[:, None]))
            assert ok.all(), (s, np.argwhere(~ok)[:5])
            checked += int((w >= 0).sum())
        return checked


def _voxels(out, flat, ref, n, layout, d0, shift, w, absl, box, k, x, y):
    """The kernel's ref_voxel / dir_voxel on arrays of voxels (slab k,
    texel (x, y)), reading the field so far from ``out``."""
    slab, sx, sy = layout
    cx = x.astype(F32) + F32(shift[0])
    cy = y.astype(F32) + F32(shift[1])
    lx, ly = _taps(cx, n), _taps(cy, n)
    corr = F32(1) - _row_sum(lx) * _row_sum(ly)
    if not ref:
        first = k == n - 1
        s1 = slab(np.minimum(k + 1, n - 1))

        def carry(i, j):
            o = s1 + i * sx + j * sy
            return np.where(first, F32(1),
                            out[o] * _attenuation(flat[o], absl))

        return _resample(lx, ly, carry, n) + corr
    w, omw = F32(w), F32(1) - F32(w)
    xlo, xhi, ylo, yhi, kmax = box
    inside = (x >= xlo) & (x <= xhi) & (y >= ylo) & (y <= yhi) & (k <= kmax)
    top = F32(n - 1)
    dx, dy = _taps(np.clip(cx, 0, top), n), _taps(np.clip(cy, 0, top), n)
    z0, z1 = slab(np.minimum(k + d0, n - 1)), slab(np.minimum(k + d0 + 1,
                                                              n - 1))
    att = _attenuation(_resample(
        dx, dy, lambda i, j: (flat[z0 + i * sx + j * sy] * omw
                              + flat[z1 + i * sx + j * sy] * w), n), absl)
    r = n - 1 - k
    la, lb = r - d0 >= 0, r - d0 - 1 >= 0

    def carry(i, j):
        o = i * sx + j * sy
        a = np.where(la, out[z0 + o], F32(1))
        b = np.where(lb, out[z1 + o], F32(1))
        return a * omw + b * w

    lres = _resample(lx, ly, carry, n)
    return np.where(inside, att * (lres + corr), F32(1))


def scheduled_field(dens, ref, axis, flip, d0, shift, w, absl, box, threads,
                    resident, point=None):
    """The field built as the launch builds it: each block runs its steps
    as soon as its producers' flags allow, the most advanced ready block
    first (a block that read a slab before its writer wrote it reads NaN).
    ``point``: X.5's light (the per-slab sweep's arguments ignored).
    Returns the field and the schedule."""
    n = dens.shape[0]
    sch = Schedule(n, ref, axis, flip, d0, shift, threads, resident, point)
    layout = _layout(n, axis, flip)
    slab, sx, sy = layout
    flat, out = dens.reshape(-1), np.full(n ** 3, np.nan, F32)
    ids = [np.nonzero(sch.owner == b)[0] for b in range(sch.blocks)]
    flags = np.zeros(sch.blocks, np.int64)
    blk = np.arange(sch.blocks)
    while (flags < sch.steps).any():
        # a block is ready when every block of its step's producer range
        # has posted that step (an empty range: at once)
        at = np.minimum(flags, sch.steps - 1)
        lo, hi = sch.lo[at, blk], sch.hi[at, blk]
        waits = (blk >= lo[:, None]) & (blk <= hi[:, None])
        posted = np.where(waits, flags[None, :], np.iinfo(np.int64).max)
        ready = (flags < sch.steps) & (posted.min(1) >= flags)
        # the most advanced ready block, the lowest index among equals
        b = int(np.flatnonzero(ready & (flags == flags[ready].max()))[0])
        s = flags[b]
        j, x, y = _voxel_at(n, sch.per, sch.minor_y, ids[b])
        r = s * sch.per + j
        keep = r < n
        k, x, y = n - 1 - r[keep], x[keep], y[keep]
        if point is not None:
            val = _point_voxels(out, flat, n, layout, point, n - 1 - s, x, y)
        else:
            val = _voxels(out, flat, ref, n, layout, d0, shift, w, absl, box,
                          k, x, y)
        assert not np.isnan(val).any(), f"block {b} step {s} read too early"
        at = slab(k) + x * sx + y * sy
        assert np.isnan(out[at]).all(), "a voxel written twice"
        out[at] = val
        flags[b] += 1
    assert not np.isnan(out).any()
    return out.reshape(n, n, n), sch


def _statics(light, n, ref):
    """(axis, flip, d0, shift, w, absl, box) as the wrappers pass them."""
    lt = np.asarray(light, F32)
    if ref:
        axis, flip, d0 = rw.light_ref_statics(lt, n)
        st = rw.ref_statics(rw._light_key(lt), n, axis, flip, d0)
        return axis, flip, d0, st.shift, st.w, st.absl, st.box
    axis, flip = rw.light_statics(lt)
    sx, sy, absl = rw._dir_statics(rw._light_key(lt), n, axis, flip)
    return axis, flip, 1, (sx, sy), 0.0, absl, (0, n - 1, 0, n - 1, n - 1)


# resident blocks of the H100 (132 SMs) at 4 blocks an SM, and a third of
# what a step needs (every thread several voxels: producers wrap around)
RESIDENT = 132 * 4


def _schedule(schedule, n, ref, d0):
    """(threads, resident blocks); None: slab by slab. "rule": the launch's
    block size and the H100's residency; "flags": 64-thread blocks, a third
    of the blocks a step needs resident."""
    if schedule == "slab":
        return None, 0
    if schedule == "rule":
        return rw.sweep_threads(n, ref, d0), RESIDENT
    return 64, -(-(d0 if ref else 1) * n * n // 64 // 3)


@pytest.mark.parametrize("light", ALL_LIGHTS)
@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("sweep", ["ref", "dir"])
@pytest.mark.parametrize("schedule", ["slab", "rule", "flags"])
def test_kernel_index_mirror_matches_plain(schedule, sweep, n, light):
    """The kernel's index arithmetic (numpy), slab by slab and in its
    schedule (the launch's block size, and small blocks with several voxels
    a thread), against the plain version, within 1e-6, on every axis, flip
    and window d0 = 1..3."""
    dens = _density(n)
    lt = np.asarray(light, F32)
    ref = sweep == "ref"
    statics = _statics(light, n, ref)
    threads, resident = _schedule(schedule, n, ref, statics[2])
    if ref:
        want = rw.light_sweep_ref_plain(torch.from_numpy(dens), lt, n,
                                        *statics[:3])
        got = (mirror_ref(dens, light) if threads is None else
               scheduled_field(dens, True, *statics, threads, resident)[0])
    else:
        want = rw.light_sweep_plain(torch.from_numpy(dens), lt, n,
                                    *statics[:2])
        got = (mirror_dir(dens, light) if threads is None else
               scheduled_field(dens, False, *statics, threads, resident)[0])
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=TOL_MIRROR)


@pytest.mark.parametrize("case", range(3 * 6))
@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("schedule", ["slab", "rule", "flags"])
def test_point_kernel_index_mirror_matches_plain(schedule, n, case):
    """X.5's index and rounding arithmetic (numpy: per-slab tap maps, each
    carry tap's crossing length), slab by slab and in its schedule (the
    launch's block size, and small blocks with several voxels a thread,
    producer ranges found every step), against light_sweep_point_plain
    within 1e-6, on every axis and side with the light far, near (its map
    contracting most) and off-axis."""
    dens = _density(n)
    light = point_lights(n)[case]
    axis, flip, lt = _point_statics(light, n)
    want = rw.light_sweep_point_plain(torch.from_numpy(dens),
                                      np.asarray(light, F32), n, axis, flip)
    threads, resident = _schedule(schedule, n, False, 1)
    got = (mirror_point(dens, light) if threads is None else
           scheduled_field(dens, False, axis, flip, 1, None, 0.0, 0.0, None,
                           threads, resident, point=lt)[0])
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=TOL_MIRROR)


CELL_CONFIGS = ("dragon-64-hq", "dragon-256-raystab-deform")


@pytest.mark.parametrize("sweep", ["ref", "dir", "point"])
def test_producers_cover_every_tap(sweep):
    """Without a volume: every carry tap's writer lies in its reader's
    producer range, at the launch's block size and in 256-thread blocks
    with several voxels a thread, for the cells' light at 64 and 256^3 and
    lights of every axis and sign with d0 = 8..13 at 256^3 (X.4: every axis
    and sign; X.5, at every step: every axis, side and kind at 64^3, and at
    256^3 each kind on the cells' axis and side, the near light in both
    block sizes; a tap map depends on the axis only through the light's
    components)."""
    if sweep == "point":
        small = (256, 60)
        cases = [(64, lt, plan) for lt in point_lights(64)
                 for plan in ("rule", small)]
        cases += [(256, point_light(2, -1.0, kind, 256), "rule")
                  for kind in POINT_KINDS]
        cases += [(256, point_light(2, -1.0, "near", 256), small)]
        for n, lt, plan in cases:
            axis, flip, light = _point_statics(lt, n)
            threads, resident = ((rw.sweep_threads(n, False, 1), RESIDENT)
                                 if plan == "rule" else plan)
            sch = Schedule(n, False, axis, flip, 1, None, threads, resident,
                           point=light)
            assert sch.covers() > 0
        return
    ref = sweep == "ref"
    cases = [(n, cell_light(c)) for c in CELL_CONFIGS for n in (64, 256)]
    if ref:
        cases += [(256, d0_light(a, sg, d, 256)) for a in range(3)
                  for sg in (1.0, -1.0) for d in range(8, 14, 5 if sg < 0
                                                       else 1)]
    else:
        cases += [(256, d0_light(a, sg, 8, 256)) for a in range(3)
                  for sg in (1.0, -1.0)]
    d0s = set()
    for n, lt in cases:
        statics = _statics(lt, n, ref)
        axis, flip, d0, shift = statics[:4]
        d0s.add(d0)
        for threads, resident in ((rw.sweep_threads(n, ref, d0), RESIDENT),
                                  (256, 60)):
            sch = Schedule(n, ref, axis, flip, d0, shift, threads, resident)
            assert sch.covers() > 0
    assert d0s == ({3, 12} | set(range(8, 14)) if ref else {1})


def test_cells_light():
    """The cells' light: d0 = 3 at 64^3 and 12 at 256^3, marching along the
    layout's minor axis."""
    for c in CELL_CONFIGS:
        lt = np.asarray(cell_light(c), F32)
        for n, d0 in ((64, 3), (256, 12)):
            axis, _, got = rw.light_ref_statics(lt, n)
            assert (axis, got) == (2, d0)


@pytest.mark.parametrize("n", [32, 64, 128, 160, 256])
def test_sweep_plan_rule(n):
    """The launch's block size (mirror of csrc/light_sweep.cu threads_for)
    at 32-256^3: 128 threads up to 16,384 voxels a step, else 256; every
    launch within the flags' 4,096 blocks at the H100's residency."""
    for d0 in range(1, 14):
        for ref in (True, False):
            count = (d0 if ref else 1) * n * n
            threads = rw.sweep_threads(n, ref, d0)
            assert threads == (128 if count <= 16384 else 256)
            assert sweep_blocks(n, ref, d0, threads, RESIDENT) <= rw.FLAGS_MAX
    # the cells' fields: X.3 at 64^3 (12,288 voxels a step, 96 blocks) and
    # 256^3 (786,432, as many blocks as stay resident)
    assert rw.sweep_threads(64, True, 3) == 128
    assert sweep_blocks(64, True, 3, 128, RESIDENT) == 96
    assert rw.sweep_threads(256, True, 12) == 256
    assert sweep_blocks(256, True, 12, 256, RESIDENT) == RESIDENT
    assert rw.sweep_threads(256, False, 1) == 256


def test_ref_box_is_the_plain_mask():
    """The host's box of texels whose p+s lies inside (the kernel's mask) is
    the plain version's per-texel mask on every light and size."""
    for n in (32, 64, 256):
        i = torch.arange(n, dtype=torch.float32)
        c = (i + 0.5) / n
        cut = False  # some light's box leaves texels out
        for light in ALL_LIGHTS:
            lt = np.asarray(light, F32)
            axis, flip, d0 = rw.light_ref_statics(lt, n)
            st = rw.ref_statics(rw._light_key(lt), n, axis, flip, d0)
            s0, s1, s2 = st.s
            xlo, xhi, ylo, yhi, kmax = st.box
            for s, lo, hi in ((s0, xlo, xhi), (s1, ylo, yhi)):
                want = ((c + s) >= 0.0) & ((c + s) <= 1.0)
                assert torch.equal(want, (i >= lo) & (i <= hi))
            assert torch.equal(c + s2 <= 1.0, i <= kmax)
            cut |= xhi - xlo + 1 < n or yhi - ylo + 1 < n
        assert cut


# ---- routing ----------------------------------------------------------------

@pytest.mark.parametrize("sweep", ["ref", "dir", "point"])
def test_use_kernel_false_takes_the_plain_version_on_any_device(sweep):
    """``use_kernel=False`` runs the plain version on a non-CPU tensor
    (here a meta tensor) and launches nothing; with the kernel asked for,
    the same tensor raises instead of falling back."""
    n, lt = 32, np.asarray(LIGHTS[0], F32)
    meta = torch.empty((n, n, n), device="meta")
    kernels = (rw.LIGHT_SWEEP_REF, rw.LIGHT_SWEEP, rw.LIGHT_SWEEP_POINT)
    before = [k.launches for k in kernels]
    if sweep == "ref":
        args = (meta, lt, n, *rw.light_ref_statics(lt, n))
        fn = rw.light_sweep_ref
    elif sweep == "point":
        args = (meta, lt, n, *rw.point_light_statics(lt, n)[:2])
        fn = rw.light_sweep_point
    else:
        args = (meta, lt, n, *rw.light_statics(lt))
        fn = rw.light_sweep
    out = fn(*args, use_kernel=False)
    assert out.device.type == "meta" and tuple(out.shape) == (n, n, n)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        fn(*args)
    assert [k.launches for k in kernels] == before


@pytest.mark.parametrize("mode", ["hq", "fast", "point"])
@pytest.mark.parametrize("use_kernels", [True, False])
def test_render_passes_use_kernels_to_the_light_field(monkeypatch, mode,
                                                      use_kernels):
    """``render(..., use_kernels=False)`` (the benchmark's plain image)
    reaches the plain sweep: the warp render hands its flag to the light
    field it picks (-hq: the reference step, -fast: the per-slab sweep,
    -pointlight: the point light's host), whose output it marches."""
    from dxrvoxelizer_tpu_torch.core.pipeline import VoxelGrid, render
    from dxrvoxelizer_tpu_torch.models.camera import OrbitCamera
    from dxrvoxelizer_tpu_torch.models.scene import Scene
    from dxrvoxelizer_tpu_torch.ops.packing import pack_bits_z
    from dxrvoxelizer_tpu_torch.utils.config import VoxelizerConfig
    from dxrvoxelizer_tpu_torch.utils.objloader import ObjMesh
    from tests.meshes import icosphere_mesh

    name = {"hq": "light_sweep_ref_host", "fast": "light_sweep_host",
            "point": "light_sweep_point_host"}[mode]
    sweep, seen = getattr(pipeline, name), []

    def spy(density, light, n, **kw):
        seen.append(kw)
        return sweep(density, light, n, **kw)

    monkeypatch.setattr(pipeline, name, spy)
    n = 32
    cfg = VoxelizerConfig(grid_size=n, width=48, height=32,
                          render_ss=1 if mode == "fast" else 2,
                          point_light=mode == "point")
    v, nrm, t = icosphere_mesh(2)
    world = v * 2.0 + np.array([0.0, 4.0, 0.0], F32)
    scene = Scene(ObjMesh(positions=world, normals=nrm, indices=t.reshape(-1),
                          aabb_min=world.min(0), aabb_max=world.max(0)),
                  pos_scale=cfg.pos_scale, light_pt=cfg.light_pt, device="cpu")
    cam = OrbitCamera(cfg.width, cfg.height)
    consts = scene.update_frame(cam.eye, cam.view_proj, cfg.width, cfg.height)
    grid = VoxelGrid(pack_bits_z(torch.from_numpy(_density(n) > 0.5)))
    img = render(grid, consts, cfg, use_kernels=use_kernels)
    assert seen == [{"use_kernel": use_kernels}]
    assert tuple(img.shape) == (32, 48, 3) and torch.isfinite(img).all()


@pytest.mark.parametrize("use_kernel", [True, False])
def test_point_host_passes_use_kernel_to_both_branches(monkeypatch,
                                                       use_kernel):
    """light_sweep_point_host hands ``use_kernel`` to the perspective sweep
    (the light beyond the volume) and to the exact per-voxel field (the
    light inside, or within a texel of the face)."""
    seen = []

    def spy(name):
        def fn(*args, **kw):
            seen.append((name, kw.get("use_kernel")))
            return torch.zeros(1)
        return fn

    monkeypatch.setattr(rw, "light_sweep_point", spy("sweep"))
    monkeypatch.setattr(rw, "precompute_light_volume", spy("exact"))
    n = 32
    dens = torch.zeros((n, n, n))
    for light in (point_light(1, -1.0, "near", n), (0.3, -0.2, 0.1)):
        rw.light_sweep_point_host(dens, np.asarray(light, F32), n,
                                  use_kernel=use_kernel)
    assert seen == [("sweep", use_kernel), ("exact", use_kernel)]


def test_sharded_light_modes_route_to_their_fields(monkeypatch):
    """The sharded frame's light field (``shard.light_volume_from_statics``)
    reaches each mode's routed function with the kernel by default:
    "persp" X.5, "ref" X.3, "dir" X.4, "exact" and "exact-dir" the exact
    field."""
    from dxrvoxelizer_tpu_torch.parallel import shard

    seen = []

    def spy(name):
        def fn(*args, **kw):
            seen.append((name, kw.get("use_kernel", True)))
            return torch.zeros(1)
        return fn

    for name in ("light_sweep_point", "light_sweep_ref", "light_sweep"):
        monkeypatch.setattr(rw, name, spy(name))
    monkeypatch.setattr(shard, "precompute_light_volume", spy("exact"))
    for mode in ("persp", "exact", "ref", "exact-dir", "dir"):
        shard.light_volume_from_statics(torch.zeros(1), LIGHTS[0], 32, 2,
                                        True, mode, l_d0=2)
    assert seen == [(name, True) for name in (
        "light_sweep_point", "exact", "light_sweep_ref", "exact",
        "light_sweep")]
