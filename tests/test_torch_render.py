"""Shear-warp renderer of the CUDA build against the JAX package on the CPU:
warp primitives, light sweeps, the march kernel's and the resolve kernel's
plain versions, and the renderer as a whole, on the same numpy inputs."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrvoxelizer_tpu.ops import raymarch_warp as jrw
from dxrvoxelizer_tpu.ops import warp as jwarp
from dxrvoxelizer_tpu.ops.march_pallas import march_pallas
from dxrvoxelizer_tpu.ops.screen_warp_pallas import bilinear_resolve
from dxrvoxelizer_tpu.ops.voxelize_ref import voxelize_parity_ref as jax_ref
from dxrvoxelizer_tpu_torch.ops import march_cuda, screen_warp_cuda, warp
from dxrvoxelizer_tpu_torch.ops import raymarch_warp as rw
from tests.meshes import box_mesh, tetrahedron_mesh
from tests.test_raymarch import _frame_consts

torch.set_num_threads(2)

CLEAR = np.array([0.0, 0.2, 0.4], dtype=np.float32)
LIGHTS = [(-10.0, 45.0, -75.0), (8.0, 12.0, -14.0), (-9.0, 11.0, 13.0),
          (30.0, -4.0, 2.0)]


def _t(a):
    return torch.tensor(np.asarray(a))


def test_interp_matrix_and_warp2d_identical_to_jax():
    rng = np.random.default_rng(5)
    coords = (rng.random((3, 20)) * 40.0 - 6.0).astype(np.float32)
    want = np.asarray(jwarp.interp_matrix(jnp.asarray(coords), 32))
    got = warp.interp_matrix(_t(coords), 32).numpy()
    np.testing.assert_array_equal(got, want)
    img = rng.random((3, 32, 32)).astype(np.float32)
    wj = np.asarray(jwarp.warp2d(jnp.asarray(img), jnp.asarray(want),
                                 jnp.asarray(want)))
    wt = warp.warp2d(_t(img), _t(want), _t(want)).numpy()
    np.testing.assert_allclose(wt, wj, rtol=0, atol=1e-6)


def _density(n, seed=3, p=0.12):
    rng = np.random.default_rng(seed)
    return (rng.random((n, n, n)) < p).astype(np.float32)


@pytest.mark.parametrize("light", LIGHTS)
@pytest.mark.parametrize("n", [32, 64])
def test_light_sweeps_match_jax(n, light):
    """-fast (per-slab recurrence) and -hq (reference-step, blocked d0
    recurrence; the exact per-voxel field where d0 = 0) light fields within
    1e-5 of the JAX ones."""
    dens = _density(n)
    lt = np.asarray(light, np.float32)
    want = np.asarray(jrw.light_sweep_host(jnp.asarray(dens), lt, n))
    got = rw.light_sweep_host(_t(dens), lt, n).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    axis, flip, d0 = jrw.light_ref_statics(lt, n)
    assert (axis, flip, d0) == rw.light_ref_statics(lt, n)
    want = np.asarray(jrw.light_sweep_ref_host(jnp.asarray(dens), lt, n))
    got = rw.light_sweep_ref_host(_t(dens), lt, n).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_light_sweep_ref_below_one_slab_raises():
    """At 16^3 the -hq light step spans less than one slab (d0 = 0): the
    port takes the exact per-voxel field (precompute_light_volume), as the
    JAX package does, within 1e-5 of JAX's."""
    lt = np.asarray(LIGHTS[0], np.float32)
    assert rw.light_ref_statics(lt, 16)[2] == 0
    dens = _density(16)
    want = np.asarray(jrw.light_sweep_ref_host(jnp.asarray(dens), lt, 16))
    got = rw.light_sweep_ref_host(_t(dens), lt, 16).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got < 0.5).any() and (got == 1.0).any()


def _march_case(n, m, ss, seed=7):
    """Random slabs + realistic per-slab scale/offset warps (coordinates
    spilling past both volume edges)."""
    rng = np.random.default_rng(seed)
    ks = n * ss
    slabs = ((rng.random((2, n, n, n)) < 0.15) * rng.random((2, n, n, n))
             ).astype(np.float32)
    _, _, wts = march_cuda.zmix_slabs(n, ss, "cpu")
    wts = wts.numpy() if ss > 1 else np.zeros(ks, np.float32)
    front = (rng.random(ks) > 0.1).astype(np.float32)
    sx = (0.6 + 0.5 * rng.random(ks)).astype(np.float32)
    sy = (0.6 + 0.5 * rng.random(ks)).astype(np.float32)
    ox = (rng.random(ks) * 6.0 - 4.0).astype(np.float32)
    oy = (rng.random(ks) * 6.0 - 4.0).astype(np.float32)
    delta = (0.02 + 0.05 * rng.random((m, m))).astype(np.float32)
    return slabs, wts, front, sx, ox, sy, oy, delta


@pytest.mark.parametrize("ss", [1, 2])
def test_plain_march_matches_pallas_kernel(ss):
    """Within the JAX package's own kernel bound (2e-6,
    tests/test_march_pallas.py); the Pallas side gets the dense
    interpolation matrices of the same scale/offset warps."""
    n, m = 32, 40
    slabs, wts, front, sx, ox, sy, oy, delta = _march_case(n, m, ss)
    wx = jwarp.interp_matrix(jwarp.scale_offset_coords(m, jnp.asarray(sx), jnp.asarray(ox)), n)
    wy = jwarp.interp_matrix(jwarp.scale_offset_coords(m, jnp.asarray(sy), jnp.asarray(oy)), n)
    t_want, s_want = march_pallas(
        jnp.asarray(slabs), jnp.asarray(wts), jnp.asarray(front), wx, wy,
        jnp.asarray(delta), ss, interpret=True,
    )
    args = [_t(a) for a in (slabs, wts, front, sx, ox, sy, oy, delta)]
    ring = march_cuda.march_ring(sx, ox, sy, oy, m, n, ss)
    t_got, s_got = march_cuda.march(*args, ss, ring=ring)  # CPU: plain version
    np.testing.assert_allclose(t_got.numpy(), np.asarray(t_want), rtol=0, atol=2e-6)
    np.testing.assert_allclose(s_got.numpy(), np.asarray(s_want), rtol=0, atol=2e-6)
    assert float(s_got.max()) > 0.0 and float(t_got.min()) < 1.0


def test_zmix_matches_march_pallas_integer_indexing():
    for ss in (1, 2, 3, 4):
        n = 16
        i0, i1, _ = march_cuda.zmix_slabs(n, ss, "cpu")
        s = np.arange(n * ss)
        want0 = np.clip((2 * s + 1 - ss) // (2 * ss), 0, n - 1)
        np.testing.assert_array_equal(i0.numpy(), want0)
        np.testing.assert_array_equal(i1.numpy(), np.clip(want0 + 1, 0, n - 1))


def test_bilinear_take_matches_jax():
    rng = np.random.default_rng(1)
    m = 48
    img = rng.random((m, m)).astype(np.float32)
    x = (rng.random(5000) * (m + 12) - 6).astype(np.float32)
    y = (rng.random(5000) * (m + 12) - 6).astype(np.float32)
    want = np.asarray(jrw._bilinear_take(jnp.asarray(img), jnp.asarray(x),
                                         jnp.asarray(y), m))
    got = screen_warp_cuda.bilinear_take(_t(img), _t(x), _t(y), m).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_plain_resolve_matches_pallas_resolver_on_coherent_coords():
    """The TPU resolver needs tile-coherent rows (real screen tiles are);
    on such coordinates it is the same bilinear sample."""
    rng = np.random.default_rng(1)
    m = 128
    sc = rng.random((m, m)).astype(np.float32)
    tr = rng.random((m, m)).astype(np.float32)
    p = 3000
    idx = np.arange(p)
    gx = ((idx // 1024) * 30.0 + ((idx // 128) % 8) * 1.7
          + rng.random(p) * 1.5 - 4.0).astype(np.float32)
    gy = (rng.random(p) * 140 - 6).astype(np.float32)
    j_sc, j_tr = bilinear_resolve(jnp.asarray(sc), jnp.asarray(tr),
                                  jnp.asarray(gx), jnp.asarray(gy),
                                  interpret=True)
    t_sc = screen_warp_cuda.bilinear_take(_t(sc), _t(gx), _t(gy), m)
    t_tr = screen_warp_cuda.bilinear_take(_t(tr), _t(gx), _t(gy), m)
    np.testing.assert_allclose(t_sc.numpy(), np.asarray(j_sc), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_tr.numpy(), np.asarray(j_tr), rtol=0, atol=1e-5)


def test_plain_resolve_composite_matches_jax():
    """resolve_plain = _bilinear_take + the _shearwarp_core composite."""
    rng = np.random.default_rng(2)
    m, h, w = 40, 12, 20
    sc = (rng.random((m, m)) * 1.5).astype(np.float32)
    tr = (rng.random((m, m)) * 1.2 - 0.1).astype(np.float32)
    gx = (rng.random(h * w) * (m + 4) - 2).astype(np.float32)
    gy = (rng.random(h * w) * (m + 4) - 2).astype(np.float32)
    ok = rng.random(h * w) > 0.3
    j_sc = jrw._bilinear_take(jnp.asarray(sc), jnp.asarray(gx), jnp.asarray(gy), m)
    j_tr = jrw._bilinear_take(jnp.asarray(tr), jnp.asarray(gx), jnp.asarray(gy), m)
    base = j_sc * 0.8 + 0.2
    trc = jnp.clip(j_tr, 0.0, 1.0)
    cc = jnp.asarray(CLEAR)
    want = jnp.stack([
        jnp.where(jnp.asarray(ok),
                  jnp.sqrt(jnp.maximum(base + (cc[c] * cc[c] - base) * trc, 0.0)),
                  cc[c])
        for c in range(3)
    ], axis=-1).reshape(h, w, 3)
    got = screen_warp_cuda.resolve_plain(_t(sc), _t(tr), _t(gx), _t(gy),
                                         _t(ok), CLEAR, h, w)
    assert got.shape == (h, w, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_statics_match_jax():
    for w, h in ((96, 64), (1280, 720), (64, 48)):
        s2l, eye_l, _ = _frame_consts(w, h)
        axis, flip, swap, m, _ = jrw.shearwarp_statics(s2l, eye_l, w, h)
        assert rw.shearwarp_statics(s2l, eye_l, w, h) == (axis, flip, swap, m)


@pytest.mark.parametrize("ss", [1, 2])
@pytest.mark.parametrize("mesh", ["box", "tet"])
def test_shearwarp_render_matches_jax(mesh, ss):
    """The renderer as a whole on the same density and light field:
    JAX's XLA path (use_pallas=False) against the port's plain kernels."""
    n, w, h = 32, 64, 48
    if mesh == "box":
        verts, _, tris = box_mesh([-0.7, -0.5, -0.6], [0.4, 0.66, 0.55])
    else:
        verts, _, tris = tetrahedron_mesh()
    dens = np.asarray(jax_ref(jnp.asarray(verts), jnp.asarray(tris), n=n),
                      np.float32)
    s2l, eye_l, light_l = _frame_consts(w, h)
    lv = np.asarray(jrw.light_sweep_host(jnp.asarray(dens), light_l, n))
    want = np.asarray(jrw.raymarch_shearwarp(
        jnp.asarray(dens), jnp.asarray(lv), s2l, eye_l, CLEAR, w, h,
        use_pallas=False, ss=ss,
    ))
    got = rw.raymarch_shearwarp(_t(dens), _t(lv), s2l, eye_l, CLEAR, w, h,
                                ss=ss).numpy()
    assert got.shape == want.shape == (h, w, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    assert np.abs(got - CLEAR).max() > 0.1  # the volume is on screen
