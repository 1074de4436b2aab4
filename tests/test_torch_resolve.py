"""The fused screen resolve and the march kernel's ring footprint of the CUDA
build, against the JAX package on the CPU.

``screen_warp_cuda.resolve_screen`` on CPU tensors (its plain version:
``screen_coords`` + ``resolve_plain``) is held against JAX's own screen
mapping, ``_bilinear_take`` and composite (``raymarch_warp._shearwarp_core``
run op by op under ``jax.disable_jit()``, its intermediates captured at
``_bilinear_take``), on cameras with swap and flip on and off.
``march_cuda.march_footprint`` (the march kernel's shared-memory ring) is
held against a brute-force count of every (chunk, tile) texel box.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrvoxelizer_tpu.ops import raymarch_warp as jrw
from dxrvoxelizer_tpu.ops.raymarch_ref import compute_start_point
from dxrvoxelizer_tpu_torch.models.camera import OrbitCamera
from dxrvoxelizer_tpu_torch.ops import march_cuda, screen_warp_cuda
from dxrvoxelizer_tpu_torch.ops import raymarch_warp as rw
from dxrvoxelizer_tpu_torch.utils import dxmath as dxm

torch.set_num_threads(2)

CLEAR = np.array([0.0, 0.2, 0.4], dtype=np.float32)
W, H, N = 48, 32, 16
# orbit yaws (fractions of the width dragged) whose statics cover swap and
# flip on and off: (axis, flip, swap) = (2, F, T), (0, T, F), (2, T, T),
# (0, F, F) for the default camera
YAWS = (0.0, 0.25, 0.5, 0.75)


def _consts(yaw: float, w=W, h=H):
    cam = OrbitCamera(w, h)
    if yaw:
        cam.orbit(yaw * w, 0.0)
    world = dxm.world_matrix(np.array([0.0, 4.0, 0.0, 2.0], np.float32),
                             np.array([0, 0, 0, 1], np.float32))
    s2l = dxm.screen_to_local(world, cam.view_proj, w, h).astype(np.float32)
    eye = dxm.transform_coord(cam.eye, dxm.inverse(world)).astype(np.float32)
    return s2l, eye


def _volumes(seed=3):
    rng = np.random.default_rng(seed)
    dens = (rng.random((N, N, N)) < 0.1).astype(np.float32)
    light = rng.random((N, N, N)).astype(np.float32)
    return dens, light


def _jax_frame(dens, light, s2l, eye, statics, ss=1):
    """JAX's XLA path op by op -> (image, [scatter, transmit] and (gi_x,
    gi_y) as its _bilinear_take received them)."""
    axis, flip, swap, m = statics
    taken = []
    orig = jrw._bilinear_take

    def spy(img, x, y, m_):
        taken.append((np.asarray(img), np.asarray(x), np.asarray(y)))
        return orig(img, x, y, m_)

    jrw._bilinear_take = spy
    try:
        with jax.disable_jit():
            img = jrw._shearwarp_core(
                jnp.asarray(dens), jnp.asarray(light), jnp.asarray(s2l),
                jnp.asarray(eye), jnp.asarray(CLEAR), N, m, W, H, axis, flip,
                swap, use_pallas=False, ss=ss)
    finally:
        jrw._bilinear_take = orig
    return np.asarray(img), taken


def test_yaws_cover_swap_and_flip():
    seen = {rw.shearwarp_statics(*_consts(y), W, H)[1:3] for y in YAWS}
    assert seen == {(False, False), (False, True), (True, False), (True, True)}


@pytest.mark.parametrize("yaw", YAWS)
def test_fused_resolve_on_cpu_matches_jax_mapping_and_composite(yaw):
    """Same intermediates in: the port's mapping within 5e-5 texels of
    JAX's (a few float32 ulps of coordinates up to about 2M; see below),
    JAX's hit pixels hit, and the image within 1e-5 (the resolve bound of
    the card checks)."""
    dens, light = _volumes()
    s2l, eye = _consts(yaw)
    statics = rw.shearwarp_statics(s2l, eye, W, H)
    axis, flip, swap, m = statics
    want, taken = _jax_frame(dens, light, s2l, eye, statics)
    (sc_j, gx_j, gy_j), (tr_j, _, _) = taken
    if swap:  # JAX hands _bilinear_take the transposed intermediates
        sc_j, tr_j, gx_j, gy_j = sc_j.T, tr_j.T, gy_j, gx_j
    mi = rw.march_inputs(torch.tensor(dens), torch.tensor(light), eye, N, m,
                         axis, flip, 1)
    img, gi_x, gi_y, ok = screen_warp_cuda.resolve_screen(
        torch.tensor(np.ascontiguousarray(sc_j)),
        torch.tensor(np.ascontiguousarray(tr_j)), s2l, eye, CLEAR, W, H,
        axis, flip, swap, mi, coords=True)
    assert img.shape == (H, W, 3) and gi_x.shape == ok.shape == (H * W,)
    np.testing.assert_allclose(gi_x.numpy(), gx_j, rtol=0, atol=5e-5)
    np.testing.assert_allclose(gi_y.numpy(), gy_j, rtol=0, atol=5e-5)
    ok_j = np.any(want.reshape(-1, 3) != CLEAR, axis=-1)
    assert np.array_equal(ok.numpy(), ok.numpy() | ok_j)  # JAX's hits hit
    assert 0 < int(ok.sum()) < H * W  # the silhouette is on screen
    np.testing.assert_allclose(img.numpy(), want, rtol=0, atol=1e-5)
    # without coords: the image alone, the same
    assert torch.equal(screen_warp_cuda.resolve_screen(
        torch.tensor(np.ascontiguousarray(sc_j)),
        torch.tensor(np.ascontiguousarray(tr_j)), s2l, eye, CLEAR, W, H,
        axis, flip, swap, mi), img)


@pytest.mark.parametrize("yaw", YAWS)
def test_screen_coords_match_jax_mapping(yaw):
    """The plain mapping alone, on the 64^3 frame's geometry: JAX's
    expressions op by op give the same mask and coordinates within 5e-5
    texels (a few float32 ulps at |gi| <= 2M: PyTorch's vectorised CPU sqrt
    is not always correctly rounded)."""
    w, h, n = 160, 90, 64
    s2l, eye = _consts(yaw, w, h)
    axis, flip, swap, m = rw.shearwarp_statics(s2l, eye, w, h)
    dens = torch.zeros((n, n, n))
    mi = rw.march_inputs(dens, dens, eye, n, m, axis, flip, 2)
    gi_x, gi_y, ok = screen_warp_cuda.screen_coords(s2l, eye, w, h, axis, flip,
                                                    m, mi, "cpu")
    with jax.disable_jit():
        sx = jnp.arange(w, dtype=jnp.float32) + 0.5
        sy = jnp.arange(h, dtype=jnp.float32) + 0.5
        px, py = (a.reshape(-1) for a in jnp.meshgrid(sx, sy, indexing="xy"))
        hh = [px * s2l[0][c] + py * s2l[1][c] + s2l[3][c] for c in range(4)]
        pn = [hh[c] / hh[3] for c in range(3)]
        d = [pn[c] - eye[c] for c in range(3)]
        d_len = jnp.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        dn = [d[c] / d_len for c in range(3)]
        # the ComputeStartPoint test, as _shearwarp_core inlines it
        _, hit = compute_start_point(jnp.stack(pn, -1), jnp.stack(dn, -1))
        perm = jrw._perm_for_axis(axis)
        ts = np.asarray(jrw.TEX_SCALE)
        d_t = [dn[perm[c]] * float(ts[perm[c]]) for c in range(3)]
        dz = -d_t[2] if flip else d_t[2]
        valid = jnp.abs(dz) > 1e-6
        safe = jnp.where(valid, dz, 1.0)
        gx = ((mi.e_xy[0] + mi.c_ref * d_t[0] / safe) - mi.gmin[0]) \
            / mi.gext[0] * m - 0.5
        gy = ((mi.e_xy[1] + mi.c_ref * d_t[1] / safe) - mi.gmin[1]) \
            / mi.gext[1] * m - 0.5
    assert np.array_equal(ok.numpy(), np.asarray(hit & valid))
    assert 0 < int(ok.sum()) < w * h
    np.testing.assert_allclose(gi_x.numpy(), np.asarray(gx), rtol=0, atol=5e-5)
    np.testing.assert_allclose(gi_y.numpy(), np.asarray(gy), rtol=0, atol=5e-5)


def _brute_footprint(sx, ox, sy, oy, m, n, ss, cz=march_cuda.CHUNK_SLABS):
    """Every pixel's clamped taps, tile by tile, over the sub-slabs of each
    chunk (those whose first z-mix slab lies in the chunk's ``cz`` source
    slabs): the largest box (rows, and columns from a multiple of 4 rounded
    up to one)."""
    kn = sx.shape[0] // ss
    z0 = march_cuda.zmix_slabs(kn, ss, "cpu")[0].numpy() if ss > 1 \
        else np.arange(kn)
    i = np.arange(m, dtype=np.float32) + np.float32(0.5)
    rows = cols = 0
    for zc in range(0, kn, cz):
        sub = np.nonzero((z0 >= zc) & (z0 < zc + cz))[0]
        fx = np.floor(sx[sub, None] * i + ox[sub, None]).astype(np.int64)
        fy = np.floor(sy[sub, None] * i + oy[sub, None]).astype(np.int64)
        tx = np.clip(np.stack([fx, fx + 1]), 0, n - 1)  # [2, S, M]
        ty = np.clip(np.stack([fy, fy + 1]), 0, n - 1)
        for t0 in range(0, m, march_cuda.TILE):
            t1 = min(t0 + march_cuda.TILE, m)
            xs, ys = tx[..., t0:t1], ty[..., t0:t1]
            rows = max(rows, int(xs.max() - xs.min() + 1))
            y0 = int(ys.min()) // 4 * 4
            cols = max(cols, -(-(int(ys.max()) + 1 - y0) // 4) * 4)
    return rows, cols


@pytest.mark.parametrize("n,m,ss", [(16, 40, 1), (64, 128, 2), (32, 36, 2),
                                    (20, 24, 3)])
def test_march_footprint_covers_every_box(n, m, ss):
    """MarchInputs' ring box equals the brute-force largest chunk box over
    every tile of the frame (magnified, at M = 2N: tiles of a few texels;
    minified, M ~ N: wider), and over random warps that spill past both
    edges and have scales above 2 (boxes wider than a tile), for chunks of
    1 to 4 slabs."""
    s2l, eye = _consts(0.1, 96, 64)
    axis, flip, _, _ = rw.shearwarp_statics(s2l, eye, 96, 64)
    dens = torch.zeros((n, n, n))
    mi = rw.march_inputs(dens, dens, eye, n, m, axis, flip, ss)
    args = [a.numpy() for a in (mi.scale_x, mi.off_x, mi.scale_y, mi.off_y)]
    cz, rows, cols = mi.ring
    assert (rows, cols) == _brute_footprint(*args, m, n, ss, cz)
    rng = np.random.default_rng(n + m)
    ks = n * ss
    sc = (0.3 + 3.0 * rng.random((2, ks))).astype(np.float32)
    off = (rng.random((2, ks)) * 2 * n - n).astype(np.float32)
    for cz in range(1, march_cuda.CHUNK_SLABS + 1):
        fp = march_cuda.march_footprint(sc[0], off[0], sc[1], off[1], m, n, ss,
                                        cz)
        assert fp == _brute_footprint(sc[0], off[0], sc[1], off[1], m, n, ss,
                                      cz)
        assert fp[0] > march_cuda.TILE and fp[1] % 4 == 0


def test_march_ring_shrinks_the_chunk_to_keep_two_blocks_per_sm():
    """Four slabs per chunk where the ring is small; fewer where two stages
    of the largest box would leave no room for a second block on an SM."""
    ks, n, m = 512, 256, 128
    wide = np.full(ks, 5.0, np.float32)  # 8 pixels span 40 texels
    zero = np.zeros(ks, np.float32)
    assert march_cuda.march_ring(wide / 8, zero, wide / 8, zero, m, n, 2)[0] \
        == march_cuda.CHUNK_SLABS
    cz, rows, cols = march_cuda.march_ring(wide, zero, wide, zero, m, n, 2)
    assert cz < march_cuda.CHUNK_SLABS
    assert 2 * 2 * (cz + 1) * rows * cols * 4 + ks * 24 + 4096 \
        <= march_cuda.RING_BUDGET


def test_chunk_starts_follow_the_zmix_slabs():
    """The kernel's chunks: chunk c's sub-slabs are exactly those whose
    first z-mix slab lies in its source slabs."""
    for kn in (4, 13, 64):
        for ss in (1, 2, 3, 4):
            z0 = march_cuda.zmix_slabs(kn, ss, "cpu")[0].numpy()
            for cz in (1, 3, 4):
                want = [int(np.argmax(z0 >= z)) for z in range(0, kn, cz)]
                assert march_cuda.chunk_starts(kn, ss, cz) == want


def test_frame_routes_through_fused_resolve_on_cpu():
    """_shearwarp_core's two routes agree on the CPU: use_kernels takes the
    wrappers (their plain versions here), use_kernels=False the plain pair."""
    dens, light = _volumes(5)
    for yaw in YAWS:
        s2l, eye = _consts(yaw)
        a = rw.raymarch_shearwarp(torch.tensor(dens), torch.tensor(light), s2l,
                                  eye, CLEAR, W, H, ss=2)
        b = rw.raymarch_shearwarp(torch.tensor(dens), torch.tensor(light), s2l,
                                  eye, CLEAR, W, H, ss=2, use_kernels=False)
        assert torch.equal(a, b)
