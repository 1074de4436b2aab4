"""The CUDA kernels against their plain torch versions, on the card.

CUDA kernels have no interpret mode, so these tests need an NVIDIA GPU
(sm_90a) and the CUDA toolkit; without one they skip. They import neither
JAX nor the JAX package, so they run where JAX is not installed; there,
skip ``tests/conftest.py`` (it imports JAX):

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dxrvoxelizer_tpu_torch.core.pipeline import FramePipeline
from dxrvoxelizer_tpu_torch.models.camera import OrbitCamera
from dxrvoxelizer_tpu_torch.models.scene import Scene
from dxrvoxelizer_tpu_torch.ops import (
    march_cuda,
    raystab_cuda,
    raystab_fast,
    raystab_mt_cuda,
    screen_warp_cuda,
    voxelize_cuda,
    voxelize_queue,
    voxelize_queue_cuda,
)
from dxrvoxelizer_tpu_torch.ops.voxelize_ref import (
    voxelize_raystab_radial_ref,
    voxelize_raystab_ref,
)
from dxrvoxelizer_tpu_torch.ops.binning import bin_triangles, voxelize_parity_binned
from dxrvoxelizer_tpu_torch.utils.config import VoxelizerConfig
from dxrvoxelizer_tpu_torch.utils.objloader import ObjMesh
# pytest puts tests/ itself on sys.path (no __init__.py there); importing
# ``meshes`` directly keeps an installed package named ``tests`` out of it
from meshes import box_mesh, icosphere_mesh, tetrahedron_mesh

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n", [32, 64, 256])
@pytest.mark.parametrize("mesh", ["box", "icosphere"])
def test_parity_kernel_bit_identical_to_plain(dev, mesh, n):
    if mesh == "box":  # faces on voxel centers: every tie rule fires
        c = [(i + 0.5) / n * 2 - 1 for i in (3, 5, 2, n - 6, n - 4, n - 9)]
        verts, _, tris = box_mesh(c[:3], c[3:])
    else:
        verts, _, tris = icosphere_mesh(4)
    coef, _ = bin_triangles(torch.from_numpy(verts).to(dev),
                            torch.from_numpy(tris.astype(np.int64)).to(dev), n)
    words = voxelize_cuda.voxelize_parity_tiles(coef, n)
    assert torch.equal(words, voxelize_cuda.voxelize_parity_tiles_plain(coef, n))
    assert words.any()


def _mesh(name, n, dev):
    if name == "box":  # faces on voxel centers: every tie rule fires
        c = [(i + 0.5) / n * 2 - 1 for i in (3, 5, 2, n - 6, n - 4, n - 9)]
        verts, _, tris = box_mesh(c[:3], c[3:])
    else:
        verts, _, tris = icosphere_mesh(4)
    return (torch.from_numpy(verts).to(dev),
            torch.from_numpy(tris.astype(np.int64)).to(dev))


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("mesh", ["box", "icosphere"])
def test_queue_kernel_bit_identical_to_plain(dev, mesh, n):
    verts, tris = _mesh(mesh, n, dev)
    coefs, ct, cn, _, stats = voxelize_queue.build_queue(verts, tris, n)
    words = voxelize_queue_cuda.voxelize_parity_queue_chunks(coefs, ct, cn, n)
    plain = voxelize_queue_cuda.voxelize_parity_queue_chunks_plain(
        coefs, ct, cn, n)
    assert torch.equal(words, plain)
    assert torch.equal(words, voxelize_parity_binned(verts, tris, n))
    assert words.any() and stats.pairs > 0


def test_deforming_call_is_sync_free(dev):
    verts, nrm, tris = icosphere_mesh(4)
    v = torch.from_numpy(verts).to(dev)
    wob = v + 0.02 * torch.from_numpy(nrm).to(dev)
    dv = voxelize_queue.DeformingVoxelizer(
        v, torch.from_numpy(tris.astype(np.int64)).to(dev), 256)
    dv(v)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        words = dv(wob)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(words, voxelize_queue.voxelize_parity_queue(
        wob, dv.tris, 256))


def _march_case(n, m, ss, seed=7):
    """Random slabs + per-slab scale/offset warps spilling past the edges."""
    rng = np.random.default_rng(seed)
    ks = n * ss
    slabs = ((rng.random((2, n, n, n)) < 0.15) * rng.random((2, n, n, n))
             ).astype(np.float32)
    wts = march_cuda.zmix_slabs(n, ss, "cpu")[2].numpy()
    if ss == 1:
        wts = np.zeros(ks, np.float32)
    front = (rng.random(ks) > 0.1).astype(np.float32)
    scale = (0.6 + 0.5 * rng.random((2, ks))).astype(np.float32)
    off = (rng.random((2, ks)) * 6.0 - 4.0).astype(np.float32)
    delta = (0.02 + 0.05 * rng.random((m, m))).astype(np.float32)
    return slabs, wts, front, scale[0], off[0], scale[1], off[1], delta


@pytest.mark.parametrize("ss", [1, 2])
def test_march_kernel_matches_plain(dev, ss):
    args = [torch.from_numpy(a).to(dev) for a in _march_case(64, 96, ss)]
    t_k, s_k = march_cuda.march(*args, ss)
    t_p, s_p = march_cuda.march_plain(*args, ss)
    assert float((t_k - t_p).abs().max()) <= 2e-6
    assert float((s_k - s_p).abs().max()) <= 2e-6


def test_resolve_kernel_matches_plain(dev):
    rng = np.random.default_rng(4)
    m, h, w = 128, 72, 128
    sc, tr = (torch.from_numpy(rng.random((m, m)).astype(np.float32)).to(dev)
              for _ in range(2))
    gx, gy = (torch.from_numpy((rng.random(h * w) * (m + 8) - 4)
                               .astype(np.float32)).to(dev) for _ in range(2))
    ok = torch.from_numpy(rng.random(h * w) > 0.2).to(dev)
    clear = np.array([0.0, 0.2, 0.4], np.float32)
    a = screen_warp_cuda.resolve(sc, tr, gx, gy, ok, clear, h, w)
    b = screen_warp_cuda.resolve_plain(sc, tr, gx, gy, ok, clear, h, w)
    assert float((a - b).abs().max()) <= 1e-6


@pytest.mark.parametrize("ss", [1, 2])
def test_gpu_frame_matches_cpu_frame(dev, ss):
    v, nrm, t = tetrahedron_mesh()
    mesh = ObjMesh(positions=v, normals=nrm, indices=t.reshape(-1),
                   aabb_min=v.min(0), aabb_max=v.max(0))
    cfg = VoxelizerConfig(grid_size=32, width=96, height=64, render_ss=ss)
    imgs = []
    for d in (dev, torch.device("cpu")):
        scene = Scene(mesh, d)
        cam = OrbitCamera(cfg.width, cfg.height)
        fc = scene.update_frame(cam.eye, cam.view_proj, cfg.width, cfg.height)
        imgs.append(FramePipeline(cfg, scene.buffers).frame(fc).cpu())
    assert float((imgs[0] - imgs[1]).abs().max()) < 2e-3


def _raystab_mesh(name, n, dev):
    if name == "box":  # faces on voxel centers: every tie rule fires
        c = [(i + 0.5) / n * 2 - 1 for i in (3, 5, 2, n - 6, n - 4, n - 9)]
        verts, nrm, tris = box_mesh(c[:3], c[3:])
    elif name == "near_origin":  # 300 triangles around the origin
        rng = np.random.default_rng(11)
        tv = (rng.standard_normal((300, 1, 3)) * 0.02
              + rng.standard_normal((300, 3, 3)) * 0.3).astype(np.float32)
        fn = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
        fn /= np.linalg.norm(fn, axis=-1, keepdims=True)
        verts, nrm = tv.reshape(-1, 3), np.repeat(fn, 3, axis=0).astype(np.float32)
        tris = np.arange(900, dtype=np.int32).reshape(300, 3)
    elif name == "dense_cone":  # a multi-chunk class with skip bounds
        verts, nrm, tris = icosphere_mesh(3, radius=0.08, center=(0.5, 0.3, -0.4))
    else:
        verts, nrm, tris = icosphere_mesh(4)
    return (torch.from_numpy(verts).to(dev), torch.from_numpy(nrm).to(dev),
            torch.from_numpy(tris.astype(np.int64)).to(dev))


@pytest.mark.parametrize("rule", ["backface", "hit"])
@pytest.mark.parametrize("mesh", ["icosphere", "box", "near_origin", "dense_cone"])
def test_raystab_kernels_bit_identical_to_plain(dev, mesh, rule):
    v, nr, t = _raystab_mesh(mesh, 64, dev)
    accel = raystab_fast.build_raystab_accel2(v, t, nr, n=64)
    streams = [tb for tb in (accel.main, accel.ov) if tb is not None]
    assert streams
    for tb in streams:
        got = raystab_cuda.fold_extract(tb, t.shape[0], 0.12, rule)
        want = raystab_cuda.fold_extract_plain(tb, t.shape[0], 0.12, rule)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        for a, b in zip(raystab_cuda.fold(tb), want[:2]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("mesh", ["icosphere", "box"])
def test_raystab_query_bit_identical_to_radial_oracle(dev, mesh):
    v, nr, t = _raystab_mesh(mesh, 64, dev)
    accel = raystab_fast.build_raystab_accel2(v, t, nr, n=64)
    occ, rgba = raystab_fast.raystab_query2(accel)
    occ_r, rgba_r = voxelize_raystab_radial_ref(v, nr, t, n=64)
    assert torch.equal(occ, occ_r) and torch.equal(rgba, rgba_r)
    assert bool(occ.any())


@pytest.mark.parametrize("mode", ["raystab", "normals"])
def test_gpu_raystab_frame_matches_cpu_frame(dev, mode):
    v, nrm, t = tetrahedron_mesh()
    mesh = ObjMesh(positions=v, normals=nrm, indices=t.reshape(-1),
                   aabb_min=v.min(0), aabb_max=v.max(0))
    cfg = VoxelizerConfig(grid_size=32, width=96, height=64,
                          inside_mode="raystab" if mode == "raystab" else "parity",
                          parity_normals=mode == "normals")
    imgs = []
    for d in (dev, torch.device("cpu")):
        scene = Scene(mesh, d)
        cam = OrbitCamera(cfg.width, cfg.height)
        fc = scene.update_frame(cam.eye, cam.view_proj, cfg.width, cfg.height)
        imgs.append(FramePipeline(cfg, scene.buffers).frame(fc).cpu())
    assert float((imgs[0] - imgs[1]).abs().max()) < 2e-3


@pytest.mark.parametrize("mesh,n", [("icosphere", 64), ("box", 64),
                                    ("near_origin", 16)])
def test_raystab_mt_kernel_bit_identical_to_plain(dev, mesh, n):
    """Kernel 2.8 against its plain version on the gen-1 accel's streams:
    per-cell slices, and the overflow stream, every ray against the overflow
    rows (the near-origin soup at 16^3: 300 rows, which JAX pads to O = 320)."""
    v, nr, t = _raystab_mesh(mesh, n, dev)
    accel = raystab_fast.build_raystab_accel(v, t, n=n)
    streams = [tb for tb in (accel.main, accel.ov) if tb is not None]
    if mesh == "near_origin":
        assert accel.ov is not None and accel.ov.rows.shape[0] == 300
    for tb in streams:
        got = raystab_mt_cuda.closest_hit(tb)
        want = raystab_mt_cuda.closest_hit_plain(tb)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    occ, rgba = raystab_fast.raystab_query(v, nr, t, accel)
    occ_p, rgba_p = raystab_fast.raystab_query(v, nr, t, accel, use_kernels=False)
    assert torch.equal(occ, occ_p) and torch.equal(rgba, rgba_p)


@pytest.mark.parametrize("mesh", ["icosphere", "box"])
def test_raystab_gen1_query_bit_identical_to_mt_oracle(dev, mesh):
    v, nr, t = _raystab_mesh(mesh, 64, dev)
    accel = raystab_fast.build_raystab_accel(v, t, n=64)
    occ, rgba = raystab_fast.raystab_query(v, nr, t, accel)
    occ_r, rgba_r = voxelize_raystab_ref(v, nr, t, n=64)
    assert torch.equal(occ, occ_r) and torch.equal(rgba, rgba_r)
    assert bool(occ.any())
