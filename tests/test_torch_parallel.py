"""Multi-device frames of the CUDA build (dxrvoxelizer_tpu_torch/parallel)
on the CPU.

Each sharded frame runs every rank's body in this process through a local
group (parallel/mesh.make_local_group: the pieces concatenated as the
all_gather concatenates them) at world sizes 1, 2 and 4, and is held
against the port's single-device path, which earlier tests hold against the
JAX package: words, ray-stab rgba and images bit for bit. The pieces
themselves (a tile group of kernel 2.2's plain version, a band of rows of
kernel 2.4's and of the gather march's, a strip slice of 2.5/2.6's) equal
the same tiles, rows or strips of the whole call. The reference frame is
held against the JAX package's ``sharded_frame`` on its 8 virtual devices.
One gloo spawn of 2 ranks runs ``ShardedFramePipeline`` over 2 orbit frames,
the app runs ``-chips 2 -warp`` once, and ``entry.dryrun_multichip(2)`` runs
every frame kind on 2 gloo ranks."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrvoxelizer_tpu.parallel import make_device_mesh as jax_mesh
from dxrvoxelizer_tpu.parallel import sharded_frame as jax_sharded_frame
from dxrvoxelizer_tpu_torch import entry
from dxrvoxelizer_tpu_torch.app.main import main as app_main
from dxrvoxelizer_tpu_torch.core.pipeline import (
    FramePipeline,
    VoxelGrid,
    _stab_accel_for,
    render,
)
from dxrvoxelizer_tpu_torch.models.camera import OrbitCamera
from dxrvoxelizer_tpu_torch.models.scene import Scene
from dxrvoxelizer_tpu_torch.ops import raystab_cuda, raystab_refit, raystab_tiled
from dxrvoxelizer_tpu_torch.ops import screen_warp_cuda as swc
from dxrvoxelizer_tpu_torch.ops import voxelize_queue as vq
from dxrvoxelizer_tpu_torch.ops import voxelize_queue_cuda as vqc
from dxrvoxelizer_tpu_torch.ops.packing import pack_bits_z, quantize_r10g10b10a2
from dxrvoxelizer_tpu_torch.ops.raymarch_fast import (
    precompute_light_volume,
    raymarch_fast,
)
from dxrvoxelizer_tpu_torch.ops.raymarch_warp import (
    light_sweep_ref_host,
    march_inputs,
    shearwarp_statics,
)
from dxrvoxelizer_tpu_torch.ops.raystab_fast import (
    build_raystab_accel2,
    raystab_query2,
)
from dxrvoxelizer_tpu_torch.ops.voxelize_ref import voxelize_parity_ref
from dxrvoxelizer_tpu_torch.parallel import (
    ShardedFramePipeline,
    make_device_mesh,
    make_local_group,
    sharded_frame,
    sharded_voxelize,
    voxelize_parity_multichip,
)
from dxrvoxelizer_tpu_torch.parallel.raystab_shard import (
    raystab_query2_sharded,
    raystab_query7_sharded,
    stream_piece,
)
from dxrvoxelizer_tpu_torch.parallel.shard import (
    queue_capacity,
    queue_group_piece,
    split,
    split_sizes,
)
from dxrvoxelizer_tpu_torch.utils.config import VoxelizerConfig
from dxrvoxelizer_tpu_torch.utils.image import read_png, to_u8
from dxrvoxelizer_tpu_torch.utils.objloader import ObjMesh
from tests.meshes import box_mesh, icosphere_mesh, tetrahedron_mesh
from tests.test_raymarch import _frame_consts

torch.set_num_threads(2)

N, W, H = 32, 64, 64
CLEAR = np.array([0.0, 0.2, 0.4], np.float32)
WORLDS = (1, 2, 4)


def _write_obj(path, v, t):
    lines = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in v]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in t]
    path.write_text("\n".join(lines) + "\n")


def _ico_world():
    v, nrm, t = icosphere_mesh(2, radius=0.6)
    return (np.asarray(v, np.float32) * 2.0 + np.array([0, 4, 0], np.float32),
            np.asarray(nrm, np.float32), t)


@pytest.fixture(scope="module")
def scene():
    v, nrm, t = _ico_world()
    return Scene(ObjMesh(positions=v, normals=nrm,
                         indices=np.asarray(t, np.int32).reshape(-1),
                         aabb_min=v.min(0), aabb_max=v.max(0)), "cpu")


def _consts(scene, cfg, yaw=0.0):
    cam = OrbitCamera(cfg.width, cfg.height)
    cam.orbit(yaw, 0.0)
    return scene.update_frame(cam.eye, cam.view_proj, cfg.width, cfg.height)


def _cfg(**kw):
    return VoxelizerConfig(grid_size=N, width=W, height=H, backend="cpu",
                           accel_cache=False, **kw)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---- the pieces against slices of the whole ---------------------------------

def test_split_is_contiguous_and_as_even_as_can_be():
    for total in (0, 1, 7, 8, 128, 131):
        for world in (1, 2, 3, 4, 8):
            spans = [split(total, world, r) for r in range(world)]
            assert spans[0][0] == 0 and spans[-1][1] == total
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
            sizes = split_sizes(total, world)
            assert max(sizes) - min(sizes) <= 1 and sum(sizes) == total


@pytest.mark.parametrize("mesh", ["tet", "ico", "box"])
@pytest.mark.parametrize("n", [32, 64])
def test_queue_tile_groups_equal_the_whole_grid(mesh, n):
    """Kernel 2.2's plain version on a tile group (the group-restricted
    device queue) equals those tiles of the whole call, for every group
    of world sizes 2, 3 and 4, including the densest one, and at world 1;
    a group holds only its own tiles' chunks."""
    if mesh == "tet":
        v, _, t = tetrahedron_mesh()
    elif mesh == "ico":
        v, _, t = icosphere_mesh(3)
    else:  # faces on voxel centres
        v, _, t = box_mesh((-0.5, -0.25, -0.75), (0.5, 0.75, 0.25))
    verts, tris = _t(v), _t(np.asarray(t, np.int64))
    coefs, spans, ct, cn, _, _ = vq.build_queue(verts, tris, n)
    whole = vqc.voxelize_parity_queue_chunks(coefs, ct, cn, n, spans=spans)
    n_tiles = (n // vqc.TILE_X) * (n // vqc.TILE_Y)
    whole_tiles = vqc.voxelize_parity_queue_chunks(
        coefs, ct, cn, n, spans=spans, tiles=n_tiles)
    assert torch.equal(vqc._tiles_to_grid(whole_tiles, n), whole)
    assert torch.equal(whole, pack_bits_z(voxelize_parity_ref(verts, tris, n=n)))
    for world in (1, 2, 3, 4):
        cap = queue_capacity(verts, tris, n, world)
        pieces = []
        for r in range(world):
            lo, hi = split(n_tiles, world, r)
            # the same group from the whole queue, and from the group's own
            got = vqc.voxelize_parity_queue_chunks(coefs, ct, cn, n, spans=spans,
                                                   tile_lo=lo, tiles=hi - lo)
            assert torch.equal(got, whole_tiles[lo:hi])
            q = vq._build_queue_device(verts, tris, n, cap, *vq.SPAN_CAP,
                                       tile_lo=lo, tile_hi=hi)
            assert bool(q[5])  # the capacity held the densest group
            live = q[3] > 0
            assert bool(((q[2][live] >= lo) & (q[2][live] < hi)).all())
            pieces.append(queue_group_piece(verts, tris, n, cap, world, r))
            assert torch.equal(pieces[-1], whole_tiles[lo:hi])
        assert torch.equal(vqc._tiles_to_grid(torch.cat(pieces), n), whole)


def test_queue_capacity_sizes_the_densest_group():
    """The headroom rule sizes every group from the densest; a capacity
    below a group's chunks clears that group's ok word (the queue would be
    truncated)."""
    v, _, t = icosphere_mesh(3)
    verts, tris = _t(v), _t(np.asarray(t, np.int64))
    n, world = 64, 4
    n_tiles = (n // vqc.TILE_X) * (n // vqc.TILE_Y)
    _, _, ct, _, _, stats = vq.build_queue(verts, tris, n)
    ct_h = ct[: stats.real_chunks].numpy()
    per = [int(((ct_h >= lo) & (ct_h < hi)).sum())
           for lo, hi in (split(n_tiles, world, r) for r in range(world))]
    cap = queue_capacity(verts, tris, n, world, headroom=1.0)
    assert cap == -(-(max(per) + 8) // 128) * 128
    dense = int(np.argmax(per))
    lo, hi = split(n_tiles, world, dense)
    short = vq._build_queue_device(verts, tris, n, max(per) - 1, *vq.SPAN_CAP,
                                   tile_lo=lo, tile_hi=hi)
    assert not bool(short[5])


def test_tile_group_arguments_are_checked():
    coefs = torch.zeros((128 * 64, 16))
    ct = torch.zeros(128, dtype=torch.int32)
    cn = torch.zeros(128, dtype=torch.int32)
    with pytest.raises(ValueError, match="tile group"):
        vqc.voxelize_parity_queue_chunks(coefs, ct, cn, 32, tile_lo=6, tiles=4)
    with pytest.raises(ValueError, match="whole grid"):
        vqc.voxelize_parity_queue_chunks(coefs, ct, cn, 32, tiles=8,
                                         variant=(True, 256))


def test_resolve_and_gather_bands_equal_the_rows_of_the_whole(scene):
    """Kernel 2.4's plain version (the screen mapping with the band's first
    row y_off, the resolve and the composite) and the gather march's on a
    band of rows equal those rows of the whole image, bit for bit, and
    their coordinates and hit mask too."""
    cfg = _cfg()
    consts = _consts(scene, cfg, yaw=40.0)
    density = voxelize_parity_ref(scene.buffers.positions_norm,
                                  scene.buffers.tris, n=N).to(torch.float32)
    s2l, eye = consts.screen_to_local, consts.local_space_eye_pt
    light = consts.local_space_light_pt
    axis, flip, swap, m = shearwarp_statics(s2l, eye, W, H)
    lv = light_sweep_ref_host(density, light, N)
    mi = march_inputs(density, lv, eye, N, m, axis, flip, 2)
    from dxrvoxelizer_tpu_torch.ops.march_cuda import march_plain

    tr, sc = march_plain(*mi.args())
    args = (sc, tr, s2l, eye, CLEAR, W)
    whole = swc.resolve_screen_plain(*args, H, axis, flip, swap, mi)
    lv_g = precompute_light_volume(density, light)
    whole_g = raymarch_fast(density, lv_g, s2l, eye, CLEAR, W, H, n_samples=32)
    for y0, rows in ((0, 16), (16, 16), (48, 16), (13, 7)):
        band = swc.resolve_screen(*args, rows, axis, flip, swap, mi,
                                  coords=True, y_off=y0)
        sl = slice(y0 * W, (y0 + rows) * W)
        assert torch.equal(band[0], whole[0][y0:y0 + rows])
        for got, want in zip(band[1:], whole[1:]):
            assert torch.equal(got, want[sl])
        band_g = raymarch_fast(density, lv_g, s2l, eye, CLEAR, W, rows,
                               n_samples=32, y_offset=float(y0))
        assert torch.equal(band_g, whole_g[y0:y0 + rows])


def test_fold_strip_slices_equal_the_whole_stream(scene):
    """Kernel 2.5/2.6's plain version on a contiguous slice of strips
    (gen-6 main and near-origin streams, gen-7 live tiles) equals those
    strips of the whole stream's outputs, bit for bit."""
    mb = scene.buffers
    a6 = _stab_accel_for(_cfg(), mb)
    a7 = raystab_tiled.build_raystab_accel7(mb.positions_norm, mb.tris,
                                            mb.normals, n=N)
    for tb, tc in ((a6.main, a6.t_count), (a7.main, a7.t_count)):
        whole = raystab_cuda.fold_extract(tb, tc, 0.12)
        for world in (2, 3, 4):
            for r in range(world):
                lo, hi = split(tb.strips, world, r)
                got = raystab_cuda.fold_extract(
                    raystab_cuda.strip_slice(tb, lo, hi), tc, 0.12)
                for g_, w_ in zip(got, whole):
                    assert torch.equal(g_, w_[lo:hi])
    piece = stream_piece(a6, 4, 1, 0.12, "backface")
    assert piece.shape[-1] == 6


# ---- the sharded query and voxelize at world 1, 2, 4 ------------------------

@pytest.mark.parametrize("rule", ["backface", "hit"])
def test_sharded_raystab_queries_bit_identical(scene, rule):
    """Gen-6 (with a near-origin stream: the box has faces on voxel
    centres) and gen-7 sharded queries equal the single-device queries'
    occupancy and rgba bit for bit at every world size."""
    mb = scene.buffers
    v, nrm, t = box_mesh((-0.5, -0.25, -0.75), (0.5, 0.75, 0.25))
    box = [_t(v), _t(nrm), _t(np.asarray(t, np.int64))]
    for verts, normals, tris in ((mb.positions_norm, mb.normals, mb.tris), box):
        a6 = build_raystab_accel2(verts, tris, normals, n=N)
        a7 = raystab_tiled.build_raystab_accel7(verts, tris, normals, n=N)
        want6 = raystab_query2(a6, rule=rule)
        want7 = raystab_tiled.raystab_query7(a7, rule=rule)
        for world in WORLDS:
            g = make_local_group(world, "cpu")
            got6 = raystab_query2_sharded(verts, normals, tris, a6, g, rule=rule)
            got7 = raystab_query7_sharded(verts, normals, tris, a7, g, rule=rule)
            for got, want in ((got6, want6), (got7, want7)):
                assert torch.equal(got[0], want[0])
                assert torch.equal(got[1], want[1])
    assert a6.ov is not None  # the box's near-origin rows were merged


def test_sharded_voxelize_and_multichip_bit_identical(scene):
    mb = scene.buffers
    for n in (32, 64):
        want = pack_bits_z(voxelize_parity_ref(mb.positions_norm, mb.tris, n=n))
        assert torch.equal(voxelize_parity_multichip(mb.positions_norm,
                                                     mb.tris, n), want)
        for world in WORLDS:
            cap = queue_capacity(mb.positions_norm, mb.tris, n, world)
            vox = sharded_voxelize(make_local_group(world, "cpu"), n, cap)
            assert torch.equal(vox(mb.positions_norm, mb.tris), want)
            assert torch.equal(voxelize_parity_multichip(
                mb.positions_norm, mb.tris, n,
                group=make_local_group(world, "cpu")), want)


# ---- whole frames at world 1, 2, 4 ------------------------------------------

FRAMES = {
    "fast": dict(render_ss=1),
    "hq": dict(),
    "pointlight": dict(point_light=True),
    "raystab": dict(inside_mode="raystab"),
}


@pytest.mark.parametrize("render_impl", ["warp", "gather"])
@pytest.mark.parametrize("kind", list(FRAMES))
def test_sharded_pipeline_bit_identical_to_single_device(scene, kind,
                                                         render_impl):
    """ShardedFramePipeline's frames equal the single-device path's bit for
    bit at world 1, 2 and 4: parity (-fast, -hq, -pointlight) against
    FramePipeline, and ray-stab against the gen-6 query the sharded
    pipeline takes on every backend (the CPU FramePipeline takes gen-1,
    which differs by design) rendered by the same renderer. Two cameras: the
    statics cache builds a frame per orientation."""
    cfg = _cfg(**FRAMES[kind])
    mb = scene.buffers
    pipes = {w: ShardedFramePipeline(cfg, mb, w, render_impl=render_impl,
                                     group=make_local_group(w, "cpu"))
             for w in WORLDS}
    single = FramePipeline(cfg, mb, render_impl=render_impl)
    for yaw in ((0.0, 100.0) if render_impl == "warp" else (0.0,)):
        consts = _consts(scene, cfg, yaw)
        if kind == "raystab":
            occ, rgba = raystab_query2(pipes[1].accel)
            want = render(VoxelGrid(words=pack_bits_z(occ),
                                    rgba=quantize_r10g10b10a2(rgba)),
                          consts, cfg, impl=render_impl)
        else:
            want = single.frame(consts)
        for w, p in pipes.items():
            got = p.frame(consts)
            assert got.shape == (H, W, 3)
            assert torch.equal(got, want), (kind, render_impl, w, yaw)
    if render_impl == "warp":
        assert len(pipes[2]._frames) == 2


@pytest.mark.parametrize("gen", ["6", "7"])
def test_sharded_deforming_raystab_bit_identical(scene, monkeypatch, gen):
    """Both refitters (gen-6 strips, gen-7 tiles, forced by
    DXRV_RAYSTAB_GEN): a wobbled frame through the sharded deforming
    pipeline equals the refitted accel's single-device query rendered by
    the same renderer, at world 1, 2 and 4; the first frame checks the
    deformation contract."""
    monkeypatch.setenv("DXRV_RAYSTAB_GEN", gen)
    cfg = _cfg(inside_mode="raystab")
    mb = scene.buffers
    from dxrvoxelizer_tpu_torch.app.main import wobbled

    base_x = mb.positions_norm[:, :1].numpy()
    moved = wobbled(mb, base_x, 3)
    consts = _consts(scene, cfg)
    want = None
    for w in WORLDS:
        p = ShardedFramePipeline(cfg, mb, w, deforming=True,
                                 group=make_local_group(w, "cpu"))
        cls = (raystab_tiled.RaystabTiledRefitter if gen == "7"
               else raystab_refit.RaystabRefitter)
        assert type(p.refitter) is cls
        if want is None:
            acc = p.refitter.refit(moved.positions_norm, moved.normals)
            query = (raystab_tiled.raystab_query7 if gen == "7"
                     else raystab_query2)
            occ, rgba = query(acc)
            want = render(VoxelGrid(words=pack_bits_z(occ),
                                    rgba=quantize_r10g10b10a2(rgba)),
                          consts, cfg)
        p.mesh = moved
        assert torch.equal(p.frame(consts), want)
        assert p._refit_checked
    p = ShardedFramePipeline(cfg, mb, 2, deforming=True,
                             group=make_local_group(2, "cpu"))
    p.mesh = dataclasses.replace(  # along the normals, beyond the pad
        mb, positions_norm=mb.positions_norm + 0.1 * mb.normals)
    with pytest.raises(RuntimeError, match="pad"):
        p.frame(consts)


def test_sharded_frame_matches_jax_sharded_frame():
    """The reference multi-device frame (x-slab oracle voxelize + gather
    band render) against the JAX package's on its 8 virtual devices, the
    same 8 ranks here: the port's gather march is held to the JAX one
    within 1e-5 (tests/test_torch_render_variants.py: its sequential
    transmittance product rounds in another order than JAX's cumprod);
    JAX's own sharded-vs-single bound is 2e-5 (tests/test_parallel.py)."""
    v, _, t = tetrahedron_mesh()
    s2l, eye, light = _frame_consts(48, 32)
    want = np.asarray(jax_sharded_frame(jax_mesh(8), N, 48, 32, n_samples=32,
                                        n_light=8)(
        jnp.asarray(v), jnp.asarray(t), jnp.asarray(s2l), jnp.asarray(eye),
        jnp.asarray(light), jnp.asarray(CLEAR)))
    frame = sharded_frame(make_local_group(8, "cpu"), N, 48, 32, n_samples=32,
                          n_light=8)
    got = frame(_t(v), _t(np.asarray(t, np.int64)), s2l, eye, light, CLEAR)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    one = sharded_frame(make_local_group(1, "cpu"), N, 48, 32, n_samples=32,
                        n_light=8)
    assert torch.equal(one(_t(v), _t(np.asarray(t, np.int64)), s2l, eye,
                           light, CLEAR), got)


# ---- the constructor's refusals and the device checks -----------------------

def test_pipeline_constructor_errors(scene):
    mb, g = scene.buffers, make_local_group(2, "cpu")
    with pytest.raises(ValueError, match="inside modes"):
        ShardedFramePipeline(_cfg(inside_mode="nope"), mb, 2, group=g)
    with pytest.raises(ValueError, match="deformpad"):
        ShardedFramePipeline(_cfg(inside_mode="raystab", deform_pad=0.0), mb,
                             2, deforming=True, group=g)
    with pytest.raises(ValueError, match="renderers"):
        ShardedFramePipeline(_cfg(), mb, 2, render_impl="ref", group=g)
    with pytest.raises(ValueError, match="not divisible by 3"):
        ShardedFramePipeline(_cfg(), mb, 3, group=make_local_group(3, "cpu"))
    with pytest.raises(ValueError, match="has 2 ranks"):
        ShardedFramePipeline(_cfg(), mb, 4, group=g)
    for impl in ("fast", "auto"):  # the warp renderer's other names
        assert ShardedFramePipeline(_cfg(), mb, 2, render_impl=impl,
                                    group=g).render_impl == "warp"


def test_device_mesh_refuses_missing_cards(monkeypatch):
    """Asking for cards the machine lacks raises (JAX's message shape);
    it never falls back to the CPU; N ranks need a process group."""
    with pytest.raises(ValueError, match="requested 2 devices, found 0"):
        make_device_mesh(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="requested 2 devices, found 1"):
        make_device_mesh(2)
    with pytest.raises(RuntimeError, match="spawn_ranks"):
        make_device_mesh(2, cpu=True)
    with pytest.raises(ValueError, match="requested 4 devices, found 1"):
        from dxrvoxelizer_tpu_torch.parallel.mesh import spawn_ranks

        spawn_ranks(print, 4)
    with pytest.raises(RuntimeError, match="no collective"):
        make_local_group(2, "cpu").all_gather(torch.zeros(1))


# ---- spawned gloo ranks -----------------------------------------------------

def test_gloo_spawn_pipeline_equals_in_process(tmp_path):
    """Two gloo ranks (spawned processes) run ShardedFramePipeline over 2
    orbit frames of -hq parity; rank 0's whole image (the bands gathered)
    equals the in-process local group's bit for bit."""
    v, _, t = _ico_world()
    obj = tmp_path / "ico.obj"
    _write_obj(obj, v, t)
    kw = dict(grid_size=N, width=W, height=H, backend="cpu")
    out = tmp_path / "img.npy"
    entry.sharded_orbit(str(obj), kw, 2, 2, str(out))
    want = entry.orbit_image(str(obj), kw, 2, 2,
                             group=make_local_group(2, "cpu"))
    assert np.array_equal(np.load(out), want.numpy())


def test_app_chips_2_warp(tmp_path, monkeypatch):
    """``-chips 2 -warp`` through the app: two gloo ranks; rank 0 writes
    the PNG, equal to the single-device run's."""
    v, _, t = _ico_world()
    _write_obj(tmp_path / "ico.obj", v, t)
    monkeypatch.chdir(tmp_path)
    base = ["-mesh", "ico.obj", "-warp", "-grid", str(N), "-width", str(W),
            "-height", str(H), "-frames", "2"]
    assert app_main([*base, "-chips", "2", "-out", "c2.png"]) == 0
    assert app_main([*base, "-out", "c1.png"]) == 0
    assert np.array_equal(read_png(tmp_path / "c2.png"),
                          read_png(tmp_path / "c1.png"))
    # headless (no terminal): the ranks run -frames in lock step
    assert app_main([*base, "-chips", "2", "-interactive"]) == 0
    monkeypatch.setenv("WORLD_SIZE", "3")  # a launcher's group of 3 ranks
    with pytest.raises(ValueError, match="launcher started 3 ranks"):
        app_main([*base, "-chips", "2"])


def test_app_chips_2_interactive_equals_one_device(tmp_path, monkeypatch,
                                                  capfd):
    """``-chips 2 -interactive``: two spawned gloo ranks in lock step, rank
    0 reading a scripted key sequence (screenshots, X toggles, orbit and
    zoom keys, a toggle while paused, quit) through a patched TTY. Its
    screenshots equal the single-device run's, shot for shot, and both
    quit on the same frame."""
    from dxrvoxelizer_tpu_torch.app import interactive
    from dxrvoxelizer_tpu_torch.parallel.mesh import spawn_ranks
    from torch_ranks import interactive_rank, script_interactive

    v, _, t = _ico_world()
    _write_obj(tmp_path / "ico.obj", v, t)
    monkeypatch.chdir(tmp_path)
    argv = ["-mesh", "ico.obj", "-warp", "-grid", str(N), "-width", str(W),
            "-height", str(H), "-frames", "30", "-interactive"]
    keys = ["s", "h", "x", "s", None, "+", "x", " ", "x", " ", "s", "k", "o",
            "s", "q"]
    c1, c2 = tmp_path / "one", tmp_path / "two"
    c1.mkdir()
    c2.mkdir()
    spawn_ranks(interactive_rank, 2, args=([*argv, "-chips", "2"], keys,
                                           str(c2)), cpu=True)
    out2 = capfd.readouterr().out
    script_interactive(interactive, keys, str(c1), monkeypatch.setattr)
    assert app_main(argv) == 0
    out1 = capfd.readouterr().out
    for out in (out1, out2):
        assert "rendered 12 frames" in out and out.count("wrote ") == 4
        assert out.count("pipeline -> ") == 3
    shots = sorted(p.name for p in c1.iterdir())
    assert shots == sorted(p.name for p in c2.iterdir()) and len(shots) == 4
    for name in shots:
        assert np.array_equal(read_png(c2 / name), read_png(c1 / name)), name


def test_dryrun_multichip_two_ranks(capfd):
    entry.dryrun_multichip(2)
    assert "dryrun_multichip(2): OK" in capfd.readouterr().out


def test_entry_frame_runs_on_the_cpu():
    fn, args = entry.entry("cpu")
    img = fn(*args)
    assert img.shape == (64, 64, 3) and bool(torch.isfinite(img).all())
    want = to_u8(img.numpy())
    assert want.std() > 0  # the tetrahedron is in view
