"""The CUDA kernels against their plain torch versions, on the card.

CUDA kernels have no interpret mode, so these tests need an NVIDIA GPU
(sm_90a) and the CUDA toolkit; without one they skip. They import neither
JAX nor the JAX package, so they run where JAX is not installed; there,
skip ``tests/conftest.py`` (it imports JAX):

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

from __future__ import annotations

import dataclasses

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
    raystab_refit,
    raystab_tiled,
    screen_warp_cuda,
    voxelize_cuda,
    voxelize_queue,
    voxelize_queue_cuda,
)
from dxrvoxelizer_tpu_torch.ops.voxelize_ref import (
    voxelize_raystab_radial_ref,
    voxelize_raystab_ref,
)
from dxrvoxelizer_tpu_torch.ops.binning import (
    bin_triangles_spans,
    voxelize_parity_binned,
)
from dxrvoxelizer_tpu_torch.utils.config import VoxelizerConfig
from dxrvoxelizer_tpu_torch.utils.objloader import ObjMesh
# pytest puts tests/ itself on sys.path (no __init__.py there); importing
# ``meshes`` directly keeps an installed package named ``tests`` out of it
from meshes import box_mesh, icosphere_mesh, tetrahedron_mesh
from torch_cases import (
    FOLD_VARIANTS,
    MT_VARIANTS,
    PARITY_VARIANTS,
    QUEUE_VARIANTS,
    SOUP_TRIS,
    SWEEP_LIGHTS,
    alpha_grid,
    by_id,
    chunks_run,
    d0_light,
    gather_cameras,
    mt_stress,
    needle_soup,
    packed_outs,
    point_lights,
    stab_stress,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n", [32, 64, 256])
@pytest.mark.parametrize("mesh", ["box", "icosphere", "soup287", "soup289"])
def test_parity_kernel_bit_identical_to_plain(dev, mesh, n):
    """Kernel 2.1 on its binned tiles: the main path (spans and counts),
    without counts, without spans (the every-column layout) and at every
    layout of the sweep, against the plain version, which tests every
    column. The needle soups need the sliver rule."""
    if mesh == "box":  # faces on voxel centers: every tie rule fires
        c = [(i + 0.5) / n * 2 - 1 for i in (3, 5, 2, n - 6, n - 4, n - 9)]
        verts, _, tris = box_mesh(c[:3], c[3:])
    elif mesh == "icosphere":
        verts, _, tris = icosphere_mesh(4)
    else:
        verts, tris = needle_soup(np.random.default_rng(int(mesh[4:])), n,
                                  SOUP_TRIS)
    coef, spans, counts, _ = bin_triangles_spans(
        torch.from_numpy(verts).to(dev),
        torch.from_numpy(tris.astype(np.int64)).to(dev), n)
    plain = voxelize_cuda.voxelize_parity_tiles_plain(coef, n)
    for sp, ct in ((spans, counts), (spans, None), (None, counts), (None, None)):
        words = voxelize_cuda.voxelize_parity_tiles(coef, n, spans=sp, counts=ct)
        assert torch.equal(words, plain), (sp is None, ct is None)
    for variant in PARITY_VARIANTS:
        sp = None if variant[0] == "column" else spans
        words = voxelize_cuda.voxelize_parity_tiles(coef, n, spans=sp,
                                                    counts=counts, variant=variant)
        assert torch.equal(words, plain), variant
    assert plain.any()


@pytest.mark.parametrize("mesh", ["box", "icosphere"])
def test_bruteforce_kernel_bit_identical_to_plain(dev, mesh):
    """Every triangle in every tile, each row tested on its span's columns,
    against the plain version and the oracle at 64^3."""
    from dxrvoxelizer_tpu_torch.ops.packing import pack_bits_z
    from dxrvoxelizer_tpu_torch.ops.voxelize_ref import voxelize_parity_ref

    verts, tris = _mesh(mesh, 64, dev)
    tiles, spans = voxelize_cuda.bruteforce_tiles(verts, tris, 64)
    words = voxelize_cuda.voxelize_parity_bruteforce(verts, tris, 64)
    assert torch.equal(words, voxelize_cuda.voxelize_parity_tiles_plain(tiles, 64))
    assert torch.equal(words, pack_bits_z(voxelize_parity_ref(verts, tris, n=64)))
    for variant in PARITY_VARIANTS[:-1]:
        assert torch.equal(words, voxelize_cuda.voxelize_parity_tiles(
            tiles, 64, spans=spans, variant=variant)), variant


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
    coefs, spans, ct, cn, _, stats = voxelize_queue.build_queue(verts, tris, n)
    words = voxelize_queue_cuda.voxelize_parity_queue_chunks(
        coefs, ct, cn, n, spans=spans)
    plain = voxelize_queue_cuda.voxelize_parity_queue_chunks_plain(
        coefs, ct, cn, n)
    assert torch.equal(words, plain)
    assert torch.equal(words, voxelize_parity_binned(verts, tris, n))
    assert words.any() and stats.pairs > 0


@pytest.mark.parametrize("variant", QUEUE_VARIANTS)
@pytest.mark.parametrize("mesh", ["box", "icosphere"])
def test_queue_kernel_variants_bit_identical_to_plain(dev, mesh, variant):
    """Both layouts of the redesigned kernel (a block per tile run, or a
    block per chunk with atomics) at every block size of the sweep, with and
    without column spans, at 256^3."""
    verts, tris = _mesh(mesh, 256, dev)
    coefs, spans, ct, cn, _, _ = voxelize_queue.build_queue(verts, tris, 256)
    plain = voxelize_queue_cuda.voxelize_parity_queue_chunks_plain(
        coefs, ct, cn, 256)
    for sp in (spans, None):
        words = voxelize_queue_cuda.voxelize_parity_queue_chunks(
            coefs, ct, cn, 256, spans=sp, variant=variant)
        assert torch.equal(words, plain)


def test_queue_kernel_512_with_overflow_rows(dev):
    """At 512^3, an icosphere plus a box with faces on voxel centres: the
    box's two z faces (4 triangles; the others project to lines) span more
    tiles than the caps and go to the overflow list, appended to every tile
    (most of whose columns they miss)."""
    n = 512
    vi, _, ti = icosphere_mesh(4)
    c = [(i + 0.5) / n * 2 - 1 for i in (3, 5, 2, n - 6, n - 4, n - 9)]
    vb, _, tb = box_mesh(c[:3], c[3:])
    verts = torch.from_numpy(np.concatenate([vi, vb])).to(dev)
    tris = torch.from_numpy(np.concatenate([ti, tb + len(vi)]).astype(np.int64)).to(dev)
    coefs, spans, ct, cn, _, stats = voxelize_queue.build_queue(verts, tris, n)
    assert stats.overflow == 4
    words = voxelize_queue_cuda.voxelize_parity_queue_chunks(
        coefs, ct, cn, n, spans=spans)
    plain = voxelize_queue_cuda.voxelize_parity_queue_chunks_plain(coefs, ct, cn, n)
    assert torch.equal(words, plain)
    assert torch.equal(words, voxelize_parity_binned(verts, tris, n))
    assert words.any()


def test_deformed_queue_bit_identical_to_plain(dev):
    """The device-built queue of two wobbled poses (its spans gathered on
    the device too) against the plain version and the host-built queue."""
    verts, nrm, tris = icosphere_mesh(4)
    v = torch.from_numpy(verts).to(dev)
    t = torch.from_numpy(tris.astype(np.int64)).to(dev)
    dv = voxelize_queue.DeformingVoxelizer(v, t, 256)
    for amp in (0.02, -0.03):
        w = v + amp * torch.from_numpy(nrm).to(dev)
        coefs, spans, ct, cn, _, ok = dv.build(w)
        assert bool(ok)
        words = voxelize_queue_cuda.voxelize_parity_queue_chunks(
            coefs, ct, cn, 256, spans=spans)
        assert torch.equal(words, voxelize_queue_cuda.voxelize_parity_queue_chunks_plain(
            coefs, ct, cn, 256))
        assert torch.equal(words, dv(w))
        assert torch.equal(words, voxelize_queue.voxelize_parity_queue(w, t, 256))


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


def _march_case(n, m, ss, seed=7, scale=(0.6, 1.1), p_occ=0.15):
    """Random slabs + per-slab scale/offset warps spilling past the edges."""
    rng = np.random.default_rng(seed)
    ks = n * ss
    slabs = ((rng.random((2, n, n, n)) < p_occ) * rng.random((2, n, n, n))
             ).astype(np.float32)
    wts = march_cuda.zmix_slabs(n, ss, "cpu")[2].numpy()
    if ss == 1:
        wts = np.zeros(ks, np.float32)
    front = (rng.random(ks) > 0.1).astype(np.float32)
    sc = (scale[0] + (scale[1] - scale[0]) * rng.random((2, ks))).astype(np.float32)
    off = (rng.random((2, ks)) * 6.0 - 4.0).astype(np.float32)
    delta = (0.02 + 0.05 * rng.random((m, m))).astype(np.float32)
    return slabs, wts, front, sc[0], off[0], sc[1], off[1], delta


def _march_vs_plain(dev, case, ss, ring=None):
    if ring is None:  # as march_inputs sizes it
        m, n = case[7].shape[0], case[0].shape[2]
        ring = march_cuda.march_ring(*case[3:7], m, n, ss)
    args = [torch.from_numpy(a).to(dev) for a in case]
    t_k, s_k = march_cuda.march(*args, ss, ring=ring)
    t_p, s_p = march_cuda.march_plain(*args, ss)
    assert float((t_k - t_p).abs().max()) <= 2e-6
    assert float((s_k - s_p).abs().max()) <= 2e-6
    return t_p, s_p


@pytest.mark.parametrize("ss", [1, 2])
def test_march_kernel_matches_plain(dev, ss):
    _march_vs_plain(dev, _march_case(64, 96, ss), ss)


@pytest.mark.parametrize("ss", [1, 2])
@pytest.mark.parametrize("case", ["wide", "dies_early", "ragged", "m512",
                                  "from_global"])
def test_redesigned_march_kernel_matches_plain(dev, case, ss):
    """The tiled march against its plain version within 2e-6: texel boxes
    wider than a tile (scales above 2), tiles whose every pixel dies within
    a few sub-slabs (the block-wide exit), M not a multiple of the 8-pixel
    tile, M = 512, and a ring too small for any box (every sub-slab read
    from global memory) or for some of them."""
    if case == "wide":
        c = _march_case(64, 48, ss, scale=(2.2, 3.5))
        assert march_cuda.march_footprint(*c[3:7], 48, 64, ss)[0] > march_cuda.TILE
        _march_vs_plain(dev, c, ss)
    elif case == "dies_early":
        c = _march_case(32, 32, ss)  # every pixel inside every slab
        sc, off = np.full_like(c[3], 0.95), np.zeros_like(c[4])
        c = (np.ones_like(c[0]), c[1], np.ones_like(c[2]), sc, off, sc, off,
             np.full_like(c[7], 0.3))
        t_p, _ = _march_vs_plain(dev, c, ss)
        assert float(t_p.max()) < 0.01
    elif case == "ragged":
        _march_vs_plain(dev, _march_case(64, 45, ss, seed=3), ss)
    elif case == "m512":
        _march_vs_plain(dev, _march_case(64, 512, ss, seed=5), ss)
    else:
        c = _march_case(32, 40, ss, seed=9, scale=(1.5, 3.0))
        _march_vs_plain(dev, c, ss, ring=(4, 0, 0))
        _march_vs_plain(dev, c, ss, ring=(4, 12, 16))
        _march_vs_plain(dev, c, ss, ring=(1, *march_cuda.march_footprint(
            *c[3:7], 40, 32, ss, 1)))


def test_march_kernel_at_frame_inputs_and_m_cap(dev):
    """march_inputs' tables at 64^3 for M = 32 and 512 (m_cap's range)."""
    from dxrvoxelizer_tpu_torch.ops.raymarch_warp import march_inputs

    rng = np.random.default_rng(2)
    dens = torch.from_numpy((rng.random((64,) * 3) < 0.2).astype(np.float32)).to(dev)
    light = torch.from_numpy(rng.random((64,) * 3).astype(np.float32)).to(dev)
    s2l, eye = _orbit_consts(0.0)
    for m in (32, 512):
        for ss in (1, 2):
            mi = march_inputs(dens, light, eye, 64, m, 2, False, ss)
            t_k, s_k = march_cuda.march(*mi.args(), ring=mi.ring)
            t_p, s_p = march_cuda.march_plain(*mi.args())
            assert float((t_k - t_p).abs().max()) <= 2e-6
            assert float((s_k - s_p).abs().max()) <= 2e-6


def test_resolve_kernel_matches_plain(dev):
    """The fused resolve on random intermediates, clamped to the edge
    everywhere: with the frame's intermediate footprint shrunk to its middle
    half, hit pixels map up to M/2 texels past both edges of the [M, M]
    intermediates, on both axes, on cameras with swap and flip on and off.
    Image within 1e-6, coordinates and mask bit for bit."""
    seen = {_resolve_vs_plain(dev, yaw, 128, shrink=0.5)
            for yaw in (0.0, 0.25, 0.5, 0.75)}
    assert seen == {(False, False), (False, True), (True, False), (True, True)}


def _orbit_consts(yaw, dy=0.0, w=1280, h=720):
    from dxrvoxelizer_tpu_torch.utils import dxmath as dxm

    cam = OrbitCamera(w, h)
    if yaw or dy:
        cam.orbit(yaw * w, dy)
    world = dxm.world_matrix(np.array([0.0, 4.0, 0.0, 2.0], np.float32),
                             np.array([0, 0, 0, 1], np.float32))
    s2l = dxm.screen_to_local(world, cam.view_proj, w, h).astype(np.float32)
    eye = dxm.transform_coord(cam.eye, dxm.inverse(world)).astype(np.float32)
    return s2l, eye


def _resolve_vs_plain(dev, yaw, m, dy=0.0, w=1280, h=720, shrink=None):
    """The fused resolve against screen_coords + resolve_plain on one orbit
    camera -> (flip, swap). ``shrink``: the intermediate footprint is cut to
    that share of its extent, about its centre, so that hit pixels map past
    both edges of the intermediates (clamp to edge); checked to happen."""
    import dataclasses

    from dxrvoxelizer_tpu_torch.ops.raymarch_warp import (
        march_inputs,
        shearwarp_statics,
    )

    s2l, eye = _orbit_consts(yaw, dy, w, h)
    axis, flip, swap, _ = shearwarp_statics(s2l, eye, w, h)
    zero = torch.zeros((64,) * 3, device=dev)
    mi = march_inputs(zero, zero, eye, 64, m, axis, flip, 2)
    if shrink is not None:
        mi = dataclasses.replace(
            mi, gmin=tuple(g + e * (1 - shrink) / 2
                           for g, e in zip(mi.gmin, mi.gext)),
            gext=tuple(e * shrink for e in mi.gext))
    rng = np.random.default_rng(m)
    sc, tr = (torch.from_numpy((rng.random((m, m)) * 1.2 - 0.1)
                               .astype(np.float32)).to(dev) for _ in range(2))
    clear = np.array([0.0, 0.2, 0.4], np.float32)
    got = screen_warp_cuda.resolve_screen(sc, tr, s2l, eye, clear, w, h, axis,
                                          flip, swap, mi, coords=True)
    want = screen_warp_cuda.resolve_screen_plain(sc, tr, s2l, eye, clear, w,
                                                 h, axis, flip, swap, mi)
    for a, b in zip(got[1:], want[1:]):  # gi_x, gi_y, ok: bit for bit
        assert torch.equal(a, b)
    assert float((got[0] - want[0]).abs().max()) <= 1e-6
    if shrink is not None:
        for gi in want[1:3]:
            fl = torch.floor(gi[want[3]])
            assert bool((fl < 0).any()) and bool((fl > m - 1).any())
    ok = want[3].reshape(h, w)
    edge = (ok[:, 1:] != ok[:, :-1]).sum() + (ok[1:] != ok[:-1]).sum()
    assert 0 < int(ok.sum()) < w * h and int(edge) > 0  # a silhouette
    return flip, swap


@pytest.mark.parametrize("m", [32, 128, 512])
def test_fused_resolve_bit_identical_mapping(dev, m):
    """gi_x, gi_y and ok equal screen_coords' bit for bit and the image is
    within 1e-6 of the plain path, on cameras with swap and flip on and off
    (orbits by a quarter turn, and two pitched ones)."""
    seen = set()
    for yaw, dy in ((0.0, 0.0), (0.25, 0.0), (0.5, 0.0), (0.75, 0.0),
                    (0.0, -150.0), (0.0, 200.0)):
        seen.add(_resolve_vs_plain(dev, yaw, m, dy))
    assert seen == {(False, False), (False, True), (True, False), (True, True)}


def test_fused_resolve_grazing_silhouette(dev):
    """Odd frame sizes at other yaws put pixel centres at other distances
    from the box's silhouette: the mask stays bit for bit there too."""
    for yaw in (0.1, 0.35, 0.6):
        _resolve_vs_plain(dev, yaw, 64, w=333, h=211)


def test_torch_cuda_division_by_a_scalar_is_a_reciprocal_multiply(dev):
    """csrc/screen_warp.cu reproduces PyTorch's CUDA true division by a CPU
    scalar as a multiplication by the scalar's float32 reciprocal."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.random(1 << 16) * 200 - 100).astype(np.float32)).to(dev)
    for s in (1.7182818, 0.3, 3.1415927, 1.3371):
        inv = np.float32(1.0) / np.float32(s)
        assert torch.equal(x / s, x * float(inv))


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


@pytest.mark.parametrize("case", ["ties", "many_chunks", "padding"])
def test_fold_kernel_stress_cases_bit_identical_to_plain(dev, case):
    """Kernels 2.5-2.7 on the synthetic strips of tests/torch_cases.py, at
    every setting of the sweep and both rules: equal t under different ids
    across chunk and sub-chunk boundaries (the lowest id wins), a strip of
    9 chunks some of which are skipped, and all-padding strips."""
    sc = stab_stress(dev)
    tb, sel = sc.tables, sc.strips[case]
    if case == "many_chunks":
        runs = chunks_run(tb, sel[0])
        assert len(runs) > 8 and runs[0] and not all(runs)
    for rule in ("backface", "hit"):
        want = raystab_cuda.fold_extract_plain(tb, sc.t_count, 0.12, rule)
        for variant in [None, *FOLD_VARIANTS]:
            got = raystab_cuda.fold_extract(tb, sc.t_count, 0.12, rule,
                                            variant=variant)
            for a, b in zip(got, want):
                assert torch.equal(a[sel], b[sel]), (variant, rule)
        if case == "ties":
            low = sc.lowest[sel]
            assert torch.equal(torch.where(low >= 0, want[1][sel], -1), low)
    for a, b in zip(raystab_cuda.fold(tb), raystab_cuda.fold_plain(tb)):
        assert torch.equal(a[sel], b[sel])


@pytest.mark.parametrize("case", ["ties", "many_chunks", "padding"])
def test_fold_kernel_reads_rows_through_ids(dev, case):
    """Kernels 2.5-2.7 on the stress strips in the row-id form (a
    deduplicated table in another order, tests/torch_cases.py ``by_id``),
    at every setting of the sweep, against the plain version on the
    materialised rows, bit for bit."""
    sc = stab_stress(dev)
    tb, sel = by_id(sc.tables), sc.strips[case]
    for rule in ("backface", "hit"):
        want = raystab_cuda.fold_extract_plain(sc.tables, sc.t_count, 0.12, rule)
        for variant in [None, *FOLD_VARIANTS]:
            got = raystab_cuda.fold_extract(tb, sc.t_count, 0.12, rule,
                                            variant=variant)
            for a, b in zip(got, want):
                assert torch.equal(a[sel], b[sel]), (variant, rule)
    for a, b in zip(raystab_cuda.fold(tb), raystab_cuda.fold_plain(sc.tables)):
        assert torch.equal(a[sel], b[sel])


@pytest.mark.parametrize("bad", [None, 2, -1])
def test_fold_kernel_traps_on_row_id_outside_the_table(dev, bad):
    """The kernels trap on a row id outside [0, rows.shape[0]) before they
    read through it, so the call fails with a CUDA error instead of reading
    past the table. A trap ends the process's CUDA context, so each case
    runs in a process of its own; ``None`` (ids inside) must pass there."""
    import subprocess
    import sys
    from pathlib import Path

    ids = [1, 0, 1] if bad is None else [1, bad, 0]
    code = (
        "import torch\n"
        "from dxrvoxelizer_tpu_torch.ops import raystab_cuda as rsc\n"
        "d = torch.device('cuda')\n"
        "tb = rsc.StripTables(rays=torch.ones((1, 4, 128), device=d),\n"
        "    cand_off=torch.zeros(1, dtype=torch.int32, device=d),\n"
        "    cand_cnt=torch.full((1,), 3, dtype=torch.int32, device=d),\n"
        "    rows=torch.zeros((2, 24), device=d),\n"
        f"    row_ids=torch.tensor({ids}, dtype=torch.int32, device=d))\n"
        "for fn in (rsc.fold, lambda x: rsc.fold_extract(x, 2, 0.12)):\n"
        "    fn(tb)\n"
        "    torch.cuda.synchronize()\n"
        "print('folded')\n")
    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=600)
    if bad is None:
        assert res.returncode == 0 and "folded" in res.stdout, res.stderr
    else:
        assert res.returncode != 0 and "folded" not in res.stdout
        assert "CUDA error" in res.stderr or "AcceleratorError" in res.stderr, \
            res.stderr[-2000:]


@pytest.mark.parametrize("gen,n", [("gen-6", 64), ("gen-7", 128)])
@pytest.mark.parametrize("mesh", ["icosphere", "near_origin"])
def test_refit_streams_kernel_bit_identical_to_plain(dev, gen, n, mesh):
    """A refitted accel's streams (gen-6: main and the near-origin one) hold
    the frame's fused matrix and row ids; the kernels read through them and
    equal the plain version on the rows they stand for, bit for bit."""
    v, nr, t = _raystab_mesh(mesh, n, dev)
    cls = (raystab_refit.RaystabRefitter if gen == "gen-6"
           else raystab_tiled.RaystabTiledRefitter)
    rf = cls(v, t, nr, n, pad=0.035, pad_dirs=nr)
    vd = v + 0.03 * torch.sin(v[:, :1] * 5.0) * nr
    accel = rf.refit(vd)
    for f in rf._ids:
        tb = getattr(accel, f)
        assert tb.row_ids is not None and tb.rows.shape[0] == t.shape[0] + 1
        rows = dataclasses.replace(tb, rows=raystab_cuda.candidate_rows(tb),
                                   row_ids=None)
        for rule in ("backface", "hit"):
            got = raystab_cuda.fold_extract(tb, t.shape[0], 0.12, rule)
            want = raystab_cuda.fold_extract_plain(rows, t.shape[0], 0.12, rule)
            for a, b in zip(got, want):
                assert torch.equal(a, b), (f, rule)
        for a, b in zip(raystab_cuda.fold(tb), raystab_cuda.fold_plain(rows)):
            assert torch.equal(a, b), f


@pytest.mark.parametrize("mesh", ["icosphere", "box", "near_origin", "dense_cone"])
def test_fold_kernel_variants_bit_identical_to_plain(dev, mesh):
    """Every setting of the fold kernel's sweep on real accels' streams."""
    v, nr, t = _raystab_mesh(mesh, 64, dev)
    accel = raystab_fast.build_raystab_accel2(v, t, nr, n=64)
    for tb in (x for x in (accel.main, accel.ov) if x is not None):
        want = raystab_cuda.fold_extract_plain(tb, t.shape[0], 0.12)
        for variant in FOLD_VARIANTS:
            got = raystab_cuda.fold_extract(tb, t.shape[0], 0.12,
                                            variant=variant)
            for a, b in zip(got, want):
                assert torch.equal(a, b), variant


@pytest.mark.parametrize("mesh", ["icosphere", "box"])
def test_raystab_query_bit_identical_to_radial_oracle(dev, mesh):
    v, nr, t = _raystab_mesh(mesh, 64, dev)
    accel = raystab_fast.build_raystab_accel2(v, t, nr, n=64)
    occ, rgba = raystab_fast.raystab_query2(accel)
    occ_r, rgba_r = voxelize_raystab_radial_ref(v, nr, t, n=64)
    assert torch.equal(occ, occ_r) and torch.equal(rgba, rgba_r)
    assert bool(occ.any())


@pytest.mark.parametrize("mesh", ["icosphere", "box", "near_origin"])
def test_gen7_query_bit_identical_to_plain_gen6_and_oracle(dev, mesh):
    """Gen-7 at 128^3: the fold kernel on its tile stream against its plain
    version (t, id, ns), and the query against gen-6's and the radial
    oracle's, both rules."""
    v, nr, t = _raystab_mesh(mesh, 128, dev)
    accel = raystab_tiled.build_raystab_accel7(v, t, nr, n=128)
    accel6 = raystab_fast.build_raystab_accel2(v, t, nr, n=128)
    for rule in ("backface", "hit"):
        got = raystab_cuda.fold_extract(accel.main, t.shape[0], 0.12, rule)
        want = raystab_cuda.fold_extract_plain(accel.main, t.shape[0], 0.12, rule)
        for a, b in zip(got, want):
            assert torch.equal(a, b), rule
        q7 = raystab_tiled.raystab_query7(accel, rule=rule)
        for q in (raystab_fast.raystab_query2(accel6, rule=rule),
                  voxelize_raystab_radial_ref(v, nr, t, n=128, rule=rule)):
            assert torch.equal(q7[0], q[0]) and torch.equal(q7[1], q[1]), rule
        assert bool(q7[0].any())


@pytest.mark.parametrize("gen,n", [("gen-6", 64), ("gen-7", 128)])
def test_refit_bit_identical_to_fresh_build_and_sync_free(dev, gen, n):
    """A refitted accel's query equals a fresh build's on two wobbled frames
    (the app's -deform, along the normals); the refit and its query run
    under set_sync_debug_mode("error")."""
    v, nr, t = _raystab_mesh("icosphere", n, dev)
    cls, build, query = (
        (raystab_refit.RaystabRefitter, raystab_fast.build_raystab_accel2,
         raystab_fast.raystab_query2) if gen == "gen-6" else
        (raystab_tiled.RaystabTiledRefitter, raystab_tiled.build_raystab_accel7,
         raystab_tiled.raystab_query7))
    rf = cls(v, t, nr, n, pad=0.035, pad_dirs=nr)
    for frame, check in ((2, True), (9, False)):
        amp = 0.03 * torch.sin(2 * np.pi * frame / 15.0 + v[:, :1] * 5.0)
        vd = v + amp * nr
        torch.cuda.synchronize()
        if not check:
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = query(rf.refit(vd, check=check))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        want = query(build(vd, t, nr, n=n))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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


@pytest.mark.parametrize("lanes", raystab_mt_cuda.SLICE_LANES)
def test_raystab_mt_kernel_stress_and_lanes_bit_identical_to_plain(dev, lanes):
    """Kernel 2.8 at every slice width and every setting of its sweep
    (threads per block, deferred division, staged rows) against its plain
    version on (t, id): the stress stream of tests/torch_cases.py (det near
    1e-10, u and v underflowing to -0.0, u + v within a few ulp of 1, t ties
    and bounds) and gen-1 streams sliced at that width (the icosphere, and
    the near-origin soup's 300 overflow rows)."""
    streams = [mt_stress(dev, lanes)]
    for mesh, n in (("icosphere", 64), ("near_origin", 16)):
        v, _, t = _raystab_mesh(mesh, n, dev)
        accel = raystab_fast.build_raystab_accel(v, t, n=n, lanes=lanes)
        assert accel.main.lanes == lanes
        streams += [tb for tb in (accel.main, accel.ov) if tb is not None]
    hits = 0
    for tb in streams:
        want = raystab_mt_cuda.closest_hit_plain(tb)
        hits += int(torch.isfinite(want[0]).sum())
        for variant in [None, *MT_VARIANTS]:
            got = raystab_mt_cuda.closest_hit(tb, variant=variant)
            for a, b in zip(got, want):
                assert torch.equal(a, b), variant
    assert hits > 0


@pytest.mark.parametrize("mesh", ["icosphere", "box"])
def test_raystab_gen1_query_bit_identical_to_mt_oracle(dev, mesh):
    v, nr, t = _raystab_mesh(mesh, 64, dev)
    accel = raystab_fast.build_raystab_accel(v, t, n=64)
    occ, rgba = raystab_fast.raystab_query(v, nr, t, accel)
    occ_r, rgba_r = voxelize_raystab_ref(v, nr, t, n=64)
    assert torch.equal(occ, occ_r) and torch.equal(rgba, rgba_r)
    assert bool(occ.any())


# ---- the render variants' kernels (hand-written for XLA code) ---------------

def _frame_density(dev, n_mesh=4, width=320, height=180):
    """An icosphere frame's density (the binned kernel at 64^3) and frame
    constants, as the gather renderer takes them."""
    from dxrvoxelizer_tpu_torch.core.pipeline import voxelize

    v, nrm, t = icosphere_mesh(n_mesh)
    world = v * np.float32(5.5) + np.array([0.0, 4.0, 0.0], np.float32)
    obj = ObjMesh(positions=world, normals=nrm, indices=t.reshape(-1),
                  aabb_min=world.min(0), aabb_max=world.max(0))
    scene = Scene(obj, device=dev)
    cam = OrbitCamera(width, height)
    fc = scene.update_frame(cam.eye, cam.view_proj, width, height)
    return voxelize(scene.buffers, 64).density().contiguous(), fc


def _random_density(dev, n, seed=5):
    g = torch.Generator().manual_seed(seed)
    d = (torch.rand((n, n, n), generator=g) < 0.2).float()
    # fractional alphas too (mip levels, R10G10B10A2 rounding)
    d[: n // 2] *= torch.rand((n // 2, n, n), generator=g)
    return d.to(dev)


def _grid(dev, kind, n):
    """A random grid with fractional alphas, or a ray-stab grid's 4-level
    alpha."""
    return _random_density(dev, n) if kind == "random" else alpha_grid(n, 3, dev)


LIGHTS = {"directional": (-10.0, 45.0, -75.0), "point": (1.3, -2.0, 4.5),
          "inside": (0.1, -0.3, 0.2)}


@pytest.mark.parametrize("n", [32, 64, 256])
@pytest.mark.parametrize("grid", ["random", "alpha"])
@pytest.mark.parametrize("light", ["directional", "point", "inside"])
def test_light_volume_kernel_bit_identical_to_plain(dev, n, grid, light):
    """csrc/light_volume.cu against its plain version (the host's voxel
    centres) on random grids with fractional alphas and on 4-level alpha
    grids: directional, point light outside and inside."""
    from dxrvoxelizer_tpu_torch.ops import raymarch_fast as rf

    point = light != "directional"
    dens = _grid(dev, grid, n)
    t, vec = rf.light_setup(n, np.array(LIGHTS[light], np.float32),
                            point_light=point)
    want = rf.light_volume_plain(dens, t, vec, point_light=point)
    assert torch.equal(rf.light_volume(dens, vec, point_light=point), want)
    assert bool((want < 1).any()) and float(want.max()) > float(want.min())


@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("grid", ["random", "alpha"])
@pytest.mark.parametrize("camera", ["frame", "inside", "axis"])
def test_gather_march_kernel_bit_identical_to_plain(dev, camera, grid, n):
    """csrc/gather_march.cu (the ray set-up fused in) against the plain
    path, gather_rays + gather_march_plain, on the card: an orbit frame, a
    camera inside the box and a view along an axis (d_i == 0 rays), on
    random and 4-level alpha grids, over the directional, point and inside
    light volumes; whole, and as a band of rows (y_offset) that equals the
    frame's rows."""
    from dxrvoxelizer_tpu_torch.ops import raymarch_fast as rf

    w, h = 320, 181  # an odd height: the axis view's middle row is on-axis
    clear = np.array([0.0, 0.2, 0.4], np.float32)
    s2l, eye, light = gather_cameras(w, h)[camera]
    dens = _grid(dev, grid, n)
    rays = rf.gather_rays(s2l, eye, w, h, 0.0, dev)
    assert bool(rays[2].any())
    for kind in ("directional", "point", "inside"):
        pt = light if kind == "directional" else np.array(LIGHTS[kind])
        lv = rf.precompute_light_volume(dens, pt, point_light=kind != "directional")
        got = rf.gather_march(dens, lv, s2l, eye, clear, w, h)
        want = rf.gather_march_plain(dens, lv, *rays, clear, px_chunk=20_000)
        assert torch.equal(got, want), kind
        assert float((got - torch.tensor(clear, device=dev)).abs().max()) > 0.05
    band = rf.gather_rays(s2l, eye, w, 40, 60.0, dev)
    got_b = rf.gather_march(dens, lv, s2l, eye, clear, w, 40, y_offset=60.0)
    assert torch.equal(got_b, rf.gather_march_plain(dens, lv, *band, clear))
    assert torch.equal(got_b, got.reshape(h, w, 3)[60:100].reshape(-1, 3))


@pytest.mark.parametrize("light", ["directional", "point"])
def test_gather_march_kernel_on_the_icosphere_frame(dev, light):
    """The fused march on the icosphere frame's density and constants (its
    light volume from the kernel) against the plain path, and raymarch_fast
    with and without the kernels."""
    from dxrvoxelizer_tpu_torch.ops import raymarch_fast as rf

    clear = np.array([0.0, 0.2, 0.4], np.float32)
    density, fc = _frame_density(dev)
    lv = rf.precompute_light_volume(density, fc.local_space_light_pt,
                                    point_light=light == "point")
    got = rf.gather_march(density, lv, fc.screen_to_local,
                          fc.local_space_eye_pt, clear, 320, 180)
    rays = rf.gather_rays(fc.screen_to_local, fc.local_space_eye_pt, 320, 180,
                          0.0, dev)
    assert torch.equal(got, rf.gather_march_plain(density, lv, *rays, clear))
    args = (density, lv, fc.screen_to_local, fc.local_space_eye_pt, clear,
            320, 180)
    assert torch.equal(rf.raymarch_fast(*args),
                       rf.raymarch_fast(*args, use_kernel=False))


@pytest.mark.parametrize("impl", ["gather", "ref"])
def test_render_variant_on_the_card_matches_the_cpu(dev, impl):
    """render(impl="gather"/"ref") with mips and the point light on the
    card within 1e-5 of the same render on the CPU."""
    from dxrvoxelizer_tpu_torch.core.pipeline import VoxelGrid, render
    from dxrvoxelizer_tpu_torch.ops.packing import pack_bits_z

    density, fc = _frame_density(dev, width=96, height=64)
    words = pack_bits_z(density > 0)
    for kw in ({}, {"show_mip": 1}, {"point_light": True}):
        cfg = VoxelizerConfig(width=96, height=64, num_samples=64,
                              num_light_samples=16, **kw)
        a = render(VoxelGrid(words=words), fc, cfg, impl=impl)
        b = render(VoxelGrid(words=words.cpu()), fc, cfg, impl=impl)
        assert float((a.cpu() - b).abs().max()) <= 1e-5, kw


# ---- the sharded frames' pieces (parallel/): tile groups, bands, slices ----

@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("mesh", ["box", "icosphere"])
def test_queue_kernel_tile_groups_bit_identical(dev, mesh, n):
    """Kernel 2.2 on each tile group of world sizes 2, 3 and 4 (the
    group's own device queue) equals its plain version and those tiles of
    the whole grid, bit for bit."""
    from dxrvoxelizer_tpu_torch.parallel.shard import queue_capacity, split

    verts, tris = _mesh(mesh, n, dev)
    whole = voxelize_queue.voxelize_parity_queue(verts, tris, n)
    n_tiles = (n // voxelize_queue_cuda.TILE_X) * (n // voxelize_queue_cuda.TILE_Y)
    for world in (2, 3, 4):
        cap = queue_capacity(verts, tris, n, world)
        pieces = []
        for r in range(world):
            lo, hi = split(n_tiles, world, r)
            coefs, spans, ct, cn, _, ok = voxelize_queue._build_queue_device(
                verts, tris, n, cap, *voxelize_queue.SPAN_CAP, tile_lo=lo,
                tile_hi=hi)
            assert bool(ok)
            got = voxelize_queue_cuda.voxelize_parity_queue_chunks(
                coefs, ct, cn, n, spans=spans, tile_lo=lo, tiles=hi - lo)
            want = voxelize_queue_cuda.voxelize_parity_queue_chunks_plain(
                coefs, ct, cn, n, tile_lo=lo, tiles=hi - lo)
            assert torch.equal(got, want)
            pieces.append(got)
        assert torch.equal(voxelize_queue_cuda._tiles_to_grid(
            torch.cat(pieces), n), whole)


@pytest.mark.parametrize("m", [32, 128])
def test_fused_resolve_bands_bit_identical(dev, m):
    """Kernel 2.4 on bands of rows from y_off: coordinates and mask equal
    screen_coords' bit for bit, the image the plain version's within 1e-6
    and the whole call's rows bit for bit."""
    from dxrvoxelizer_tpu_torch.ops.raymarch_warp import (
        march_inputs,
        shearwarp_statics,
    )

    w, h = 1280, 720
    s2l, eye = _orbit_consts(0.25, 0.0, w, h)
    axis, flip, swap, _ = shearwarp_statics(s2l, eye, w, h)
    zero = torch.zeros((64,) * 3, device=dev)
    mi = march_inputs(zero, zero, eye, 64, m, axis, flip, 2)
    rng = np.random.default_rng(m)
    sc, tr = (torch.from_numpy((rng.random((m, m)) * 1.2 - 0.1)
                               .astype(np.float32)).to(dev) for _ in range(2))
    clear = np.array([0.0, 0.2, 0.4], np.float32)
    args = (sc, tr, s2l, eye, clear, w)
    whole = screen_warp_cuda.resolve_screen(*args, h, axis, flip, swap, mi)
    for y0, rows in ((0, 360), (360, 360), (180, 180), (701, 19)):
        got = screen_warp_cuda.resolve_screen(*args, rows, axis, flip, swap, mi,
                                              coords=True, y_off=y0)
        want = screen_warp_cuda.resolve_screen_plain(*args, rows, axis, flip,
                                                     swap, mi, y_off=y0)
        for a, b in zip(got[1:], want[1:]):
            assert torch.equal(a, b)
        assert float((got[0] - want[0]).abs().max()) <= 1e-6
        assert torch.equal(got[0], whole[y0:y0 + rows])


@pytest.mark.parametrize("mesh", ["icosphere", "box", "near_origin"])
def test_fold_kernel_strip_slices_bit_identical(dev, mesh):
    """Kernel 2.5/2.6 on contiguous strip slices of world sizes 2 and 4
    equals the whole stream's strips and its plain version, bit for bit."""
    from dxrvoxelizer_tpu_torch.parallel.shard import split

    v, nr, t = _raystab_mesh(mesh, 64, dev)
    accel = raystab_fast.build_raystab_accel2(v, t, nr, n=64)
    for tb in (s for s in (accel.main, accel.ov) if s is not None):
        whole = raystab_cuda.fold_extract(tb, t.shape[0], 0.12)
        for world in (2, 4):
            for r in range(world):
                lo, hi = split(tb.strips, world, r)
                sl = raystab_cuda.strip_slice(tb, lo, hi)
                got = raystab_cuda.fold_extract(sl, t.shape[0], 0.12)
                want = raystab_cuda.fold_extract_plain(sl, t.shape[0], 0.12)
                for a, b, c in zip(got, want, whole):
                    assert torch.equal(a, b) and torch.equal(a, c[lo:hi])


@pytest.mark.parametrize("inside", ["parity", "raystab"])
def test_sharded_pipeline_on_the_card_bit_identical(dev, inside, tmp_path,
                                                    monkeypatch):
    """ShardedFramePipeline's rank bodies at world 1, 2 and 4 on the card
    (a local group) equal FramePipeline's frame (parity) or the gen-6
    query's (ray-stab), bit for bit."""
    from dxrvoxelizer_tpu_torch.core.pipeline import VoxelGrid, render
    from dxrvoxelizer_tpu_torch.ops.packing import pack_bits_z, quantize_r10g10b10a2
    from dxrvoxelizer_tpu_torch.parallel import (
        ShardedFramePipeline,
        make_local_group,
    )

    monkeypatch.setenv("DXRVOX_ACCEL_CACHE", str(tmp_path))
    v, nrm, t = icosphere_mesh(4)
    v = np.asarray(v, np.float32) * 2.0 + np.array([0, 4, 0], np.float32)
    scene = Scene(ObjMesh(positions=v, normals=np.asarray(nrm, np.float32),
                          indices=t.astype(np.int32).reshape(-1),
                          aabb_min=v.min(0), aabb_max=v.max(0)), dev)
    cfg = VoxelizerConfig(grid_size=64, width=320, height=180,
                          inside_mode=inside)
    cam = OrbitCamera(cfg.width, cfg.height)
    consts = scene.update_frame(cam.eye, cam.view_proj, cfg.width, cfg.height)
    want = None
    for world in (1, 2, 4):
        p = ShardedFramePipeline(cfg, scene.buffers, world,
                                 group=make_local_group(world, dev))
        got = p.frame(consts)
        if want is None:
            if inside == "parity":
                want = FramePipeline(cfg, scene.buffers).frame(consts)
            else:
                occ, rgba = raystab_fast.raystab_query2(p.accel)
                want = render(VoxelGrid(words=pack_bits_z(occ),
                                        rgba=quantize_r10g10b10a2(rgba)),
                              consts, cfg)
        assert torch.equal(got, want), world


# the light recurrences (csrc/light_sweep.cu) against their plain versions
# (FP32; the plain versions' matmuls may round their two-term sums in
# another order: 1e-5 as against JAX, tests/test_torch_render.py)
TOL_SWEEP = 1e-5


def _sweep_lights(n):
    """The CPU tests' lights, and lights of every major axis and sign with
    the 256^3 windows d0 = 8 and 13 (d0 = 2..6 at 32^3 to 128^3)."""
    return [*SWEEP_LIGHTS, (-10.0, 45.0, -75.0),
            *(d0_light(a, sg, d, 256) for a in range(3) for sg in (1.0, -1.0)
              for d in (8, 13))]


@pytest.mark.parametrize("n", [32, 64, 128, 160, 256])
@pytest.mark.parametrize("sweep", ["ref", "dir", "point"])
def test_light_sweep_kernels_match_plain(dev, sweep, n):
    """X.3 (the reference step), X.4 (the per-slab sweep) and X.5 (the
    point light's perspective sweep) launch once per field and stay within
    1e-5 of their plain versions on the card, every axis, flip and window
    (X.5: every axis and side, the light far, near and off-axis; 160^3,
    n not a power of two, where the tap map is most sensitive to how the
    texel centres (k + 0.5) / n round);
    ``use_kernel=False`` launches nothing."""
    from dxrvoxelizer_tpu_torch.ops import raymarch_warp as rw

    dens = _grid(dev, "random", n)
    kernel = {"ref": rw.LIGHT_SWEEP_REF, "dir": rw.LIGHT_SWEEP,
              "point": rw.LIGHT_SWEEP_POINT}[sweep]
    for light in (point_lights(n) if sweep == "point" else _sweep_lights(n)):
        lt = np.asarray(light, np.float32)
        if sweep == "ref":
            args = (dens, lt, n, *rw.light_ref_statics(lt, n))
            fn = rw.light_sweep_ref
        elif sweep == "point":
            args = (dens, lt, n, *rw.point_light_statics(lt, n)[:2])
            fn = rw.light_sweep_point
        else:
            args = (dens, lt, n, *rw.light_statics(lt))
            fn = rw.light_sweep
        before = kernel.launches
        got = fn(*args)
        assert kernel.launches == before + 1
        want = fn(*args, use_kernel=False)
        assert kernel.launches == before + 1
        err = float((got - want).abs().max())
        assert err <= TOL_SWEEP, (light, err)
        assert bool((want < 0.5).any()), light
        assert sweep != "ref" or bool((want == 1.0).any()), light


# ---- the grid glue (csrc/grid.cu: X.6, X.7, X.8) ---------------------------

def _held_equal(got, want):
    """Every output == its plain version's, NaN at the same places, and bit
    for bit (the sign of a zero included)."""
    for g_, w_ in zip(got, want):
        if g_ is None and w_ is None:
            continue
        assert g_.shape == w_.shape and g_.dtype == w_.dtype
        if g_.dtype.is_floating_point:
            assert torch.equal(g_.view(torch.int32), w_.view(torch.int32))
        else:
            assert torch.equal(g_, w_)


@pytest.mark.parametrize("n,form", [
    (n, f) for n in (16, 32, 64, 256)
    for f in ("tiled", "grid", "gated_tiled", "gated_grid")
    if n % 32 == 0 or f == "tiled"])  # words need n % 32 == 0
def test_grid_untile_bit_identical_to_plain(dev, n, form):
    """X.6 in each form, rounded and not, against its plain chain on the
    card (which multiplies by the float32 reciprocals, as the kernel does),
    on channels drawn from the tie set; its density is the rounded alpha.
    The grid-order forms have no X.6 kernel: there X.10 with an identity
    ray -> slot map is held against X.6's grid-order plain chain."""
    from dxrvoxelizer_tpu_torch.ops import grid_cuda as gc
    from torch_cases import grid_channels, grid_order_streams

    tiled = form.endswith("tiled")
    d = grid_channels(n, n, tiles=tiled)
    gate = (torch.from_numpy(d["gate"]).to(dev) if form.startswith("gated")
            else None)
    if tiled:
        tids = torch.from_numpy(d["tids"]).to(dev)
        src, tiles = torch.from_numpy(d["ns"]).to(dev), (tids, gc.tile_slots(tids, n))
    else:
        src, tiles = torch.from_numpy(d["src"]).to(dev), None
    for q in (True, False):
        kw = dict(tiles=tiles, gate=gate, quantize=q, words=n % 32 == 0)
        kernel = gc.UNTILE if tiled else gc.MERGE
        before = kernel.launches
        if tiled:
            got = gc.untile(src, n, **kw)
        else:
            accel, outs = grid_order_streams(src, n)
            got = gc.merge(accel, outs, gate=gate, quantize=q,
                           words=n % 32 == 0)
        assert kernel.launches == before + 1
        want = gc.untile(src, n, use_kernel=False, **kw)
        _held_equal(got, (want[0], want[1], want[0][..., 3]))


@pytest.mark.parametrize("n", [32, 64, 256])
def test_grid_unpack_bit_identical_to_plain(dev, n):
    from dxrvoxelizer_tpu_torch.ops import grid_cuda as gc
    from torch_cases import grid_channels

    w = torch.from_numpy(grid_channels(n, n, tiles=False)["gate"]).to(dev)
    before = gc.UNPACK.launches
    got = gc.unpack_density(w, n)
    assert gc.UNPACK.launches == before + 1
    _held_equal((got,), (gc.unpack_density_plain(w, n),))


@pytest.mark.parametrize("n", [8, 13, 40, 64, 132, 256])
def test_grid_slabs_bit_identical_to_plain(dev, n):
    """X.8 in all six (axis, flip) pairs on contiguous volumes (rows of
    16-byte quads for axes 0 and 1, the tile transpose for axis 2, its last
    tiles cut at 132^3; single voxels where n % 4 != 0), on a strided
    density (an rgba grid's alpha) and on a density one float past a
    16-byte boundary (the voxel paths)."""
    from dxrvoxelizer_tpu_torch.ops import grid_cuda as gc

    gen = torch.Generator(device=dev).manual_seed(n)
    rgba = torch.rand((n, n, n, 4), generator=gen, device=dev)
    light = torch.rand((n, n, n), generator=gen, device=dev)
    shifted = torch.rand(n ** 3 + 1, generator=gen, device=dev)[1:].view(
        n, n, n)
    for dens in (rgba[..., 3].contiguous(), rgba[..., 3], shifted):
        for axis in range(3):
            for flip in (False, True):
                before = gc.SLABS.launches
                got = gc.slabs(dens, light, axis, flip)
                assert gc.SLABS.launches == before + 1
                _held_equal((got,), (gc.slabs_plain(dens, light, axis, flip),))


# ---- the refit's rows (csrc/refit_rows.cu: X.9) and gen-6's merge (X.10) ---

def _rows_mesh(name, dev):
    """The CPU tests' meshes for X.9: the ray-stab meshes, the cells'
    torus and the needle soups (seeded normals)."""
    if name == "torus":
        from dxrvoxelizer_tpu_torch.bench import torus_mesh

        v, t = torus_mesh()
        nr = v / np.linalg.norm(v, axis=-1, keepdims=True)
        return (torch.from_numpy(v).to(dev),
                torch.from_numpy(nr.astype(np.float32)).to(dev),
                torch.from_numpy(t).to(dev))
    if name.startswith("soup"):
        rng = np.random.default_rng(int(name[4:]))
        v, t = needle_soup(rng, 64, SOUP_TRIS)
        nr = rng.standard_normal(v.shape).astype(np.float32)
        return (torch.from_numpy(v).to(dev), torch.from_numpy(nr).to(dev),
                torch.from_numpy(t.astype(np.int64)).to(dev))
    return _raystab_mesh(name, 64, dev)


@pytest.mark.parametrize("mesh", ["icosphere", "box", "near_origin", "torus",
                                  "soup287", "soup289"])
def test_refit_rows_bit_identical_to_plain(dev, mesh):
    """X.9 (int64 and int32 triangles) equals ``_fused_coef_matrix`` run on
    the card bit for bit, the padding row included; float64 vertices and
    normals raise."""
    v, nr, t = _rows_mesh(mesh, dev)
    want = raystab_fast._fused_coef_matrix(v, t, nr)
    for tris in (t, t.to(torch.int32)):
        before = raystab_fast.REFIT_ROWS.launches
        got = raystab_fast.fused_coef_matrix(v, tris, nr)
        assert raystab_fast.REFIT_ROWS.launches == before + 1
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    for bad in ((v.double(), t, nr), (v, t, nr.double())):
        with pytest.raises(ValueError, match="float32"):
            raystab_fast.fused_coef_matrix(*bad)


@pytest.mark.parametrize("t_count", [0, 1, 127, 255, 256, 257, 700])
def test_refit_rows_blocks_and_tails(dev, t_count):
    """X.9 where T + 1 rows fill the last block of 128 (127, 255) or leave a
    remainder, and with no triangle (the padding row alone), on int64 and
    int32 triangles that start 16-byte aligned (16-byte index units):
    == ``_fused_coef_matrix`` on the card, every bit; triangles that do not
    start 16-byte aligned raise before a launch."""
    rng = np.random.default_rng(t_count)
    v = torch.from_numpy(rng.standard_normal((97, 3)).astype(np.float32)).to(dev)
    nr = torch.from_numpy(rng.standard_normal((97, 3)).astype(np.float32)).to(dev)
    t = torch.from_numpy(rng.integers(0, 97, (t_count, 3))).to(dev)
    want = raystab_fast._fused_coef_matrix(v, t, nr)
    for dtype in (torch.int64, torch.int32):
        flat = torch.zeros(3 * t_count + 4, dtype=dtype, device=dev)
        for off in (0, 1):  # the allocation is 16-byte aligned; +1 is not
            tris = flat[off:off + 3 * t_count].view(t_count, 3)
            tris.copy_(t)
            before = raystab_fast.REFIT_ROWS.launches
            if off and t_count:
                with pytest.raises(ValueError, match="16-byte aligned"):
                    raystab_fast.fused_coef_matrix(v, tris, nr)
                assert raystab_fast.REFIT_ROWS.launches == before
                continue
            got = raystab_fast.fused_coef_matrix(v, tris, nr)
            assert raystab_fast.REFIT_ROWS.launches == before + 1
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("mesh", ["icosphere", "box", "near_origin"])
def test_grid_merge_bit_identical_to_plain(dev, mesh):
    """X.10 on a 64^3 gen-6 accel (the near-origin soup: both streams),
    rounded and not, gated by the parity words and not, on the fold's
    outputs and on strided views of the sharded frames' packed pieces,
    against ``_merge_streams2`` + ``untile_plain`` run on the card, bit for
    bit; without its near-origin stream too."""
    from dxrvoxelizer_tpu_torch.ops import grid_cuda as gc

    v, nr, t = _raystab_mesh(mesh, 64, dev)
    accel = raystab_fast.build_raystab_accel2(v, t, nr, n=64)
    words = voxelize_parity_binned(v, t, 64)
    for rule in ("backface", "hit"):
        outs = raystab_fast._stream_outs2(accel, 0.12, rule)
        cases = [outs, packed_outs(outs)]
        if len(outs) == 2:
            cases.append({"main": outs["main"]})
        for o in cases:
            for q in (True, False):
                for gate in (None, words if rule == "hit" else None):
                    before = (gc.MERGE.launches, gc.UNTILE.launches)
                    got = gc.merge(accel, o, gate=gate, quantize=q)
                    assert (gc.MERGE.launches, gc.UNTILE.launches) == (
                        before[0] + 1, before[1])
                    want = gc.merge_plain(accel, o, gate=gate, quantize=q)
                    _held_equal(got, (want[0], want[1], want[0][..., 3]))


def test_refit_and_gen6_query_launch_x9_and_x10(dev):
    """A gen-6 refit launches X.9 once and its query X.10 once (not X.6),
    and both equal their plain versions; so does a gen-7 refit's X.9."""
    from dxrvoxelizer_tpu_torch.ops import grid_cuda as gc

    v, nr, t = _raystab_mesh("icosphere", 64, dev)
    for cls, n in ((raystab_refit.RaystabRefitter, 64),
                   (raystab_tiled.RaystabTiledRefitter, 128)):
        rf = cls(v, t, nr, n=n, pad=0.02)
        vd = v * 1.01
        before = raystab_fast.REFIT_ROWS.launches
        acc = rf.refit(vd, nr)
        assert raystab_fast.REFIT_ROWS.launches == before + 1
        rows = next(tb.rows for tb in (acc.main, getattr(acc, "ov", None))
                    if tb is not None)
        want = raystab_fast._fused_coef_matrix(vd, t, nr)
        assert torch.equal(rows.view(torch.int32), want.view(torch.int32))
        if n == 64:
            assert torch.equal(acc.ray_slot, rf.rest_accel.ray_slot)
            before = (gc.MERGE.launches, gc.UNTILE.launches)
            got = raystab_fast.raystab_grid2(acc)
            assert (gc.MERGE.launches, gc.UNTILE.launches) == (before[0] + 1,
                                                               before[1])
            want = raystab_fast.raystab_grid2(acc, use_kernels=False)
            _held_equal(got, (want[0], want[1], want[0][..., 3]))


@pytest.mark.parametrize("kind", ["gen6", "gen7", "gen6_deform",
                                  "gen7_deform", "parity"])
def test_sharded_frames_launch_the_glue_kernels(dev, kind, tmp_path,
                                                monkeypatch):
    """The sharded frames' merges on the card, world 1 and 2 (a local
    group): gen-7 through X.6 and gen-6 through X.10, a deforming frame's
    refit through X.9, the parity frame's words through X.7; each ray-stab
    image equal to the one the band renderer makes from the old chains'
    density (``untile7`` or ``_merge_streams2``, then ``_stab_density``),
    bit for bit."""
    from dxrvoxelizer_tpu_torch.ops import grid_cuda as gc
    from dxrvoxelizer_tpu_torch.parallel import (
        ShardedFramePipeline,
        make_local_group,
    )
    from dxrvoxelizer_tpu_torch.parallel import raystab_shard as rs

    monkeypatch.setenv("DXRVOX_ACCEL_CACHE", str(tmp_path))
    v, nrm, t = icosphere_mesh(4)
    v = np.asarray(v, np.float32) * 2.0 + np.array([0, 4, 0], np.float32)
    scene = Scene(ObjMesh(positions=v, normals=np.asarray(nrm, np.float32),
                          indices=t.astype(np.int32).reshape(-1),
                          aabb_min=v.min(0), aabb_max=v.max(0)), dev)
    n = 128 if kind.startswith("gen7") else 64
    cfg = VoxelizerConfig(grid_size=n, width=320, height=180,
                          inside_mode="parity" if kind == "parity" else "raystab")
    cam = OrbitCamera(cfg.width, cfg.height)
    consts = scene.update_frame(cam.eye, cam.view_proj, cfg.width, cfg.height)
    want_k = {"parity": gc.UNPACK, "gen6": gc.MERGE, "gen7": gc.UNTILE}[
        kind.split("_")[0]]
    deform = kind.endswith("deform")
    for world in (1, 2):
        p = ShardedFramePipeline(cfg, scene.buffers, world, deforming=deform,
                                 group=make_local_group(world, dev))
        counts = [k.launches for k in (want_k, raystab_fast.REFIT_ROWS)]
        got = p.frame(consts)
        assert want_k.launches > counts[0]
        assert (raystab_fast.REFIT_ROWS.launches > counts[1]) == deform
        if kind == "parity":
            continue
        # the old chains' density, rendered by the frame's band renderer
        fn = next(iter(p._frames.values()))
        second = scene.buffers.normals if deform else scene.buffers.tris
        args = (scene.buffers.positions_norm, second,
                np.asarray(consts.screen_to_local, np.float32),
                np.asarray(consts.local_space_eye_pt, np.float32),
                np.asarray(consts.local_space_light_pt, np.float32),
                np.array(cfg.clear_color, np.float32))
        accel = p.refitter.refit(*args[:2]) if deform else p.accel
        if kind.startswith("gen7"):
            _, rgba = raystab_tiled.untile7(
                accel, raystab_cuda.fold_extract(accel.main, accel.t_count,
                                                 0.12)[2])
        else:
            rgba = raystab_fast._merge_streams2(
                accel, raystab_fast._stream_outs2(accel, 0.12, "backface"))
            rgba = rgba.reshape(n, n, n, 4)
        old = rs._stab_density(rgba)
        want = torch.cat([fn.band(r, (None, None, old), args)
                          for r in range(world)])
        assert torch.equal(got, want), world
