"""Render variants of the CUDA build against the JAX package on the CPU:
trilinear sampling, the shader-exact oracle, the gather renderer and its
light volume (the two CUDA kernels' plain versions), the point-light sweep,
mips, and ``render`` over every renderer and switch, on the same numpy
inputs (the Engine's alternate X-key pipeline: tests/test_torch_app.py)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrvoxelizer_tpu.core.pipeline import VoxelGrid as JaxVoxelGrid
from dxrvoxelizer_tpu.core.pipeline import render as jax_render
from dxrvoxelizer_tpu.ops import mips as jmips
from dxrvoxelizer_tpu.ops import raymarch_fast as jfast
from dxrvoxelizer_tpu.ops import raymarch_ref as jref
from dxrvoxelizer_tpu.ops import raymarch_warp as jrw
from dxrvoxelizer_tpu.ops.packing import pack_bits_z as jax_pack
from dxrvoxelizer_tpu.ops.sampling import sample_trilinear as jax_sample
from dxrvoxelizer_tpu.ops.voxelize_ref import voxelize_parity_ref as jax_parity
from dxrvoxelizer_tpu.utils.config import VoxelizerConfig as JaxConfig
from dxrvoxelizer_tpu_torch.core.pipeline import render
from dxrvoxelizer_tpu_torch.ops import mips
from dxrvoxelizer_tpu_torch.ops import raymarch_fast as rf
from dxrvoxelizer_tpu_torch.ops import raymarch_ref as rr
from dxrvoxelizer_tpu_torch.ops import raymarch_warp as rw
from dxrvoxelizer_tpu_torch.ops.sampling import sample_trilinear
from dxrvoxelizer_tpu_torch.state import grid_from_numpy
from dxrvoxelizer_tpu_torch.utils.config import VoxelizerConfig
from tests.meshes import box_mesh, icosphere_mesh, tetrahedron_mesh
from tests.test_raymarch import _frame_consts
from tests.torch_cases import gather_cameras, point_light

torch.set_num_threads(2)

CLEAR = np.array([0.0, 0.2, 0.4], dtype=np.float32)
W, H = 48, 32
# a point light inside the volume (local space): the exact per-voxel field
LIGHT_INSIDE = np.array([0.3, -0.2, 0.1], np.float32)
# the port's sequential transmittance product against JAX's cumprod (another
# rounding order) and XLA:CPU's contractions: fields and images within 1e-5
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _density(scene: str, n: int) -> np.ndarray:
    """An occupancy grid as float32: a seeded random grid or a test mesh
    voxelized by the JAX package's counting oracle."""
    if scene == "random":
        return (np.random.default_rng(11).random((n, n, n)) < 0.15).astype(
            np.float32)
    if scene == "tet":
        v, _, t = tetrahedron_mesh()
    elif scene == "box":
        v, _, t = box_mesh((-0.6, -0.5, -0.4), (0.5, 0.6, 0.3))
    else:
        v, _, t = icosphere_mesh(2)
    return np.asarray(jax_parity(jnp.asarray(v), jnp.asarray(t), n=n)).astype(
        np.float32)


def test_sample_trilinear_matches_jax():
    """The 8-tap LINEAR_CLAMP read on a non-cubic volume, coordinates
    inside and outside [0,1]: within 1e-7 (the same operations in the same
    order; JAX runs op by op here)."""
    rng = np.random.default_rng(2)
    vol = rng.random((8, 12, 16)).astype(np.float32)
    tex = (rng.random((5, 7, 3)) * 1.6 - 0.3).astype(np.float32)
    want = np.asarray(jax_sample(jnp.asarray(vol), jnp.asarray(tex)))
    got = sample_trilinear(_t(vol), _t(tex)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert got.shape == (5, 7)


def test_compute_start_point_bit_for_bit():
    """Ray-box entry on random rays (inside, outside, axis-parallel
    components): entry and hit bit for bit (JAX op by op)."""
    rng = np.random.default_rng(3)
    pos = (rng.random((400, 3)) * 6.0 - 3.0).astype(np.float32)
    pos[:50] *= 0.3  # inside the box
    d = rng.normal(size=(400, 3)).astype(np.float32)
    d[50:80, 0] = 0.0
    d[80:100, 1:] = 0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    je, jh = jref.compute_start_point(jnp.asarray(pos), jnp.asarray(d))
    te, th = rr.compute_start_point(_t(pos), _t(d))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert 50 <= int(th.sum()) < 400


@pytest.mark.parametrize("n", [8, 32])
def test_mips_match_jax(n):
    """downsample2, quantize_a2, generate_mips and mip_level bit for bit:
    on occupancy, on thirds (means that sit on a half of the 2-bit
    rounding) and on random floats, with and without requantization."""
    rng = np.random.default_rng(n)
    grids = [(rng.random((n, n, n)) < 0.4).astype(np.float32),
             (rng.integers(0, 4, (n, n, n)) / np.float32(3)).astype(np.float32),
             rng.random((n, n, n)).astype(np.float32) * 1.4 - 0.2]
    for g in grids:
        np.testing.assert_array_equal(
            mips.downsample2(_t(g)).numpy(),
            np.asarray(jmips.downsample2(jnp.asarray(g))))
        np.testing.assert_array_equal(
            mips.quantize_a2(_t(g)).numpy(),
            np.asarray(jmips.quantize_a2(jnp.asarray(g))))
        for q in (False, True):
            want = jmips.generate_mips(jnp.asarray(g), quantize_alpha=q)
            got = mips.generate_mips(_t(g), quantize_alpha=q)
            assert len(got) == len(want) == n.bit_length()
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            for level in (0, 1, 2):
                np.testing.assert_array_equal(
                    mips.mip_level(_t(g), level, quantize_alpha=q).numpy(),
                    np.asarray(jmips.mip_level(jnp.asarray(g), level,
                                               quantize_alpha=q)))


def _light(kind, light_l):
    return LIGHT_INSIDE if kind == "inside" else light_l


@pytest.mark.parametrize("scene,n", [("random", 16), ("tet", 32), ("box", 32)])
@pytest.mark.parametrize("kind", ["directional", "point", "inside"])
def test_light_volume_matches_jax(scene, n, kind):
    """The light volume kernel's plain version (directional, point light
    outside and inside the volume) within 1e-5 of JAX's cumprod form, in
    one voxel chunk and in chunks smaller than the volume (the same
    values)."""
    _, _, light_l = _frame_consts(W, H)
    light = _light(kind, light_l)
    point = kind != "directional"
    dens = _density(scene, n)
    want = np.asarray(jfast.precompute_light_volume(
        jnp.asarray(dens), jnp.asarray(light), point_light=point))
    got = rf.precompute_light_volume(_t(dens), light, point_light=point)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    t, vec = rf.light_setup(n, light, point_light=point)
    chunked, steps = rf.light_volume_plain(_t(dens), t, vec, point_light=point,
                                           chunk=n * n * 3, return_steps=True)
    assert torch.equal(chunked, got)
    assert 0 < int(steps.max()) <= 32 and bool((got < 1).any())


@pytest.mark.parametrize("scene,n", [("tet", 32), ("box", 16), ("ico", 32)])
def test_raymarch_fast_matches_jax(scene, n):
    """The gather march's plain version over a light volume, whole and in
    pixel chunks smaller than the image (the same values), and a band of
    rows (``y_offset``): within 1e-5 of JAX's masked cumprod form."""
    s2l, eye_l, light_l = _frame_consts(W, H)
    dens = _density(scene, n)
    lv = np.asarray(jfast.precompute_light_volume(jnp.asarray(dens),
                                                  jnp.asarray(light_l)))
    want = np.asarray(jfast.raymarch_fast(
        jnp.asarray(dens), jnp.asarray(lv), jnp.asarray(s2l),
        jnp.asarray(eye_l), jnp.asarray(CLEAR), W, H, px_chunk=512))
    got = rf.raymarch_fast(_t(dens), _t(lv), s2l, eye_l, CLEAR, W, H)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert got.shape == (H, W, 3) and np.abs(want - CLEAR).max() > 0.1
    small = rf.raymarch_fast(_t(dens), _t(lv), s2l, eye_l, CLEAR, W, H,
                             px_chunk=500)
    assert torch.equal(small, got)
    band_want = np.asarray(jfast.raymarch_fast(
        jnp.asarray(dens), jnp.asarray(lv), jnp.asarray(s2l),
        jnp.asarray(eye_l), jnp.asarray(CLEAR), W, 8, y_offset=12.0))
    band = rf.raymarch_fast(_t(dens), _t(lv), s2l, eye_l, CLEAR, W, 8,
                            y_offset=12.0)
    np.testing.assert_allclose(band.numpy(), band_want, rtol=0, atol=TOL)
    np.testing.assert_array_equal(band.numpy(), got.numpy()[12:20])


def _kernel_ray_setup(s2l, eye, w, h, y_offset):
    """csrc/gather_march.cu ``setup_ray`` replayed in numpy float32, one
    rounding per operation in the kernel's order -> (entry, dir, hit)."""
    f = np.float32
    m = np.asarray(s2l, f).reshape(16)
    e_ = np.asarray(eye, f)
    py, px = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    sx = (px.astype(f) + f(0.5)).reshape(-1)
    sy = ((py.astype(f) + f(0.5)) + f(y_offset)).reshape(-1)
    hh = [sx * m[k] for k in range(4)]
    hh = [hh[k] + sy * m[4 + k] for k in range(4)]
    hh = [hh[k] + f(0.0) * m[8 + k] for k in range(4)]
    hh = [hh[k] + f(1.0) * m[12 + k] for k in range(4)]
    pos = [hh[k] / hh[3] for k in range(3)]
    d = [pos[k] - e_[k] for k in range(3)]
    nrm = np.sqrt((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2])
    d = [d[k] / nrm for k in range(3)]
    inside = np.all([np.abs(p) <= 1 for p in pos], axis=0)
    u_best = np.full(sx.shape, f(3.402823466e38))
    hit = np.zeros(sx.shape, bool)
    for i in range(3):
        j, k = (i + 1) % 3, (i + 2) % 3
        nz = d[i] != 0
        di = np.where(nz, d[i], f(1.0))
        u = (-np.sign(di) - pos[i]) / di
        ok = (nz & (u >= 0) & (np.abs(d[j] * u + pos[j]) <= 1)
              & (np.abs(d[k] * u + pos[k]) <= 1) & (u < u_best))
        u_best = np.where(ok, u, u_best)
        hit |= ok
    u_final = np.where(~inside & hit, u_best, f(0.0))
    entry = [np.where(inside, pos[k], np.clip(d[k] * u_final + pos[k], -1, 1))
             for k in range(3)]
    return np.stack(entry, -1), np.stack(d, -1), inside | hit


@pytest.mark.parametrize("camera", ["frame", "inside", "axis"])
def test_fused_ray_setup_replica_matches_gather_rays(camera):
    """The gather kernel's fused ray set-up, replayed in numpy float32 in
    its order of operations, equals the plain set-up (``gather_rays``) bit
    for bit: the orbit frame, a camera inside the box and a view along an
    axis (exact zero components), whole and as bands (``y_offset``)."""
    w, h = 33, 25
    s2l, eye, _ = gather_cameras(w, h)[camera]
    for y0, rows in ((0.0, h), (7.0, 9)):
        want = rf.gather_rays(s2l, eye, w, rows, y0)
        got = _kernel_ray_setup(s2l, eye, w, rows, y0)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b.numpy())
    # the voxel centres the light kernel computes, (i + 0.5) / n * 2 - 1
    for n in (16, 32, 64, 256, 512):
        i = np.arange(n, dtype=np.float32)
        t = (i + np.float32(0.5)) / np.float32(n) * np.float32(2) - np.float32(1)
        np.testing.assert_array_equal(t, rf.voxel_centres(n).numpy())


@pytest.mark.parametrize("camera", ["inside", "axis"])
def test_raymarch_fast_cameras_match_jax(camera):
    """The plain gather frame from a camera inside the box and along an
    axis (d_i == 0 rays) within 1e-5 of JAX's, whole and as a band."""
    w, h = 33, 25
    s2l, eye_l, light_l = gather_cameras(w, h)[camera]
    dens = _density("box", 16)
    lv = np.asarray(jfast.precompute_light_volume(jnp.asarray(dens),
                                                  jnp.asarray(light_l)))
    args = (jnp.asarray(dens), jnp.asarray(lv), jnp.asarray(s2l),
            jnp.asarray(eye_l), jnp.asarray(CLEAR))
    want = np.asarray(jfast.raymarch_fast(*args, w, h, px_chunk=512))
    got = rf.raymarch_fast(_t(dens), _t(lv), s2l, eye_l, CLEAR, w, h)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert np.abs(want - CLEAR).max() > 0.1
    band = rf.raymarch_fast(_t(dens), _t(lv), s2l, eye_l, CLEAR, w, 6,
                            y_offset=10.0)
    np.testing.assert_array_equal(band.numpy(), got.numpy()[10:16])


@pytest.mark.parametrize("point", [False, True])
def test_raymarch_ref_matches_jax(point):
    """The shader-exact oracle (positions accumulated, breaks as masks,
    the nested light march): within 1e-5 of JAX's jitted oracle (XLA:CPU
    may contract its lerps into FMAs); the point light with a band of
    rows."""
    s2l, eye_l, light_l = _frame_consts(W, H)
    dens = _density("tet", 32)
    kw = {"n_samples": 64, "n_light": 16, "y_offset": 6.0} if point else {}
    h = 20 if point else H
    want = np.asarray(jref.raymarch_ref(
        jnp.asarray(dens), jnp.asarray(s2l), jnp.asarray(eye_l),
        jnp.asarray(light_l), jnp.asarray(CLEAR), W, h, point_light=point,
        **kw))
    got = rr.raymarch_ref(_t(dens), s2l, eye_l, light_l, CLEAR, W, h,
                          point_light=point, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert np.abs(want - CLEAR).max() > 0.1


@pytest.mark.parametrize("n", [16, 32])
def test_light_sweep_point_matches_jax(n):
    """The point-light field on both branches of light_sweep_point_host
    (the perspective sweep with the light outside the volume, the exact
    per-voxel field with it inside), and the sweep itself: within 1e-5."""
    _, _, light_l = _frame_consts(W, H)
    dens = _density("random", n)
    for light in (light_l, LIGHT_INSIDE, np.array([0.2, -3.0, 0.4], np.float32)):
        want = np.asarray(jrw.light_sweep_point_host(jnp.asarray(dens), light, n))
        got = rw.light_sweep_point_host(_t(dens), light, n)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    l_t = np.asarray(rr.TEX_SCALE) * light_l + 0.5
    axis = int(np.argmax(np.abs(l_t - 0.5)))
    flip = bool(l_t[axis] < 0.5)
    want = np.asarray(jrw.light_sweep_point(jnp.asarray(dens),
                                            jnp.asarray(light_l), n, axis, flip))
    got = rw.light_sweep_point(_t(dens), light_l, n, axis, flip)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("n", [16, 32])
def test_light_sweep_point_plain_matches_jax_near_light(n, axis, sign):
    """The plain version of the -pointlight sweep (X.5's) against JAX's
    ``light_sweep_point`` within 1e-5, with the light 1.25 texels past the
    far face (the tap map contracting most), on every major axis and
    side."""
    light = np.asarray(point_light(axis, sign, "near", n), np.float32)
    dens = _density("random", n)
    flip = sign < 0
    want = np.asarray(jrw.light_sweep_point(jnp.asarray(dens),
                                            jnp.asarray(light), n, axis, flip))
    got = rw.light_sweep_point_plain(_t(dens), light, n, axis, flip)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    assert (want < 0.5).any()


# ---- render over every renderer and switch ---------------------------------

N = 32
RENDER_CASES = [
    # (impl, config changes, tolerance): the shear-warp images at the
    # tet-golden bound of the other render tests, the others at 1e-5
    ("warp", {"show_mip": 1}, 2e-3),
    ("warp", {"show_mip": 2}, 2e-3),
    ("warp", {"show_mip": 1, "use_mutex": True}, 2e-3),
    ("warp", {"show_mip": 2, "use_mutex": True}, 2e-3),
    ("warp", {"point_light": True}, 2e-3),
    ("warp", {"point_light": True, "light_pt": (0.0, 4.0, 0.0)}, 2e-3),
    ("gather", {}, TOL),
    ("gather", {"show_mip": 1}, TOL),
    ("gather", {"point_light": True}, TOL),
    ("ref", {"num_samples": 64, "num_light_samples": 16}, TOL),
    ("ref", {"num_samples": 64, "num_light_samples": 16, "show_mip": 2,
             "point_light": True}, TOL),
]


@pytest.mark.parametrize("impl,changes,tol", RENDER_CASES)
def test_render_matches_jax(impl, changes, tol):
    """core.render with every renderer, mip level (with and without
    -usemutex) and the point light (outside and, at the scene's centre,
    inside the volume) against the JAX package's render on the same grid
    and frame constants."""
    from dxrvoxelizer_tpu.models.scene import Scene as JaxScene
    from dxrvoxelizer_tpu.utils.objloader import ObjMesh as JaxObjMesh
    from dxrvoxelizer_tpu_torch.models.camera import OrbitCamera

    v, nrm, t = icosphere_mesh(2)
    world = v * 2.0 + np.array([0.0, 4.0, 0.0], np.float32)
    obj = JaxObjMesh(positions=world, normals=nrm, indices=t.reshape(-1),
                     aabb_min=world.min(0), aabb_max=world.max(0))
    jcfg = JaxConfig(grid_size=N, width=W, height=H, **changes)
    scene = JaxScene(obj, pos_scale=jcfg.pos_scale, light_pt=jcfg.light_pt)
    cam = OrbitCamera(W, H)
    fc = scene.update_frame(cam.eye, cam.view_proj, W, H)
    words = np.asarray(jax_pack(jax_parity(scene.buffers.positions_norm,
                                           scene.buffers.tris, n=N)))
    want = np.asarray(jax_render(JaxVoxelGrid(words=jnp.asarray(words)), fc,
                                 jcfg, impl=impl))
    cfg = VoxelizerConfig(grid_size=N, width=W, height=H, **changes)
    got = render(grid_from_numpy(words, "cpu"), fc, cfg, impl=impl)
    assert got.shape == (H, W, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    assert np.abs(want - CLEAR).max() > 0.1  # the volume is in the frame
