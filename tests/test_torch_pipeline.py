"""The whole static parity frame of the CUDA build against the JAX package's
CPU frame, the tet golden image, the Engine, the app, and the state
helpers."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dxrvoxelizer_tpu.core.pipeline import FramePipeline as JaxFramePipeline
from dxrvoxelizer_tpu.models.scene import Scene as JaxScene
from dxrvoxelizer_tpu.utils.config import VoxelizerConfig as JaxConfig
from dxrvoxelizer_tpu.utils.objloader import ObjMesh as JaxObjMesh
from dxrvoxelizer_tpu_torch.core.pipeline import FRAME_COUNT, FramePipeline, render
from dxrvoxelizer_tpu_torch.ez import Engine
from dxrvoxelizer_tpu_torch.models.camera import OrbitCamera
from dxrvoxelizer_tpu_torch.models.scene import Scene
from dxrvoxelizer_tpu_torch.state import (
    MESH_FIELDS,
    grid_from_numpy,
    mesh_buffers_from_numpy,
)
from dxrvoxelizer_tpu_torch.utils.config import VoxelizerConfig
from dxrvoxelizer_tpu_torch.utils.image import read_png
from dxrvoxelizer_tpu_torch.utils.objloader import ObjMesh, load_obj
from tests.meshes import icosphere_mesh, tetrahedron_mesh

torch.set_num_threads(2)

GOLDENS = Path(__file__).parent / "goldens"
W, H, N = 96, 64, 32


def _tet_obj(cls):
    v, nrm, t = tetrahedron_mesh()
    return cls(positions=v, normals=nrm, indices=t.reshape(-1),
               aabb_min=v.min(axis=0), aabb_max=v.max(axis=0))


def _jax_frame(ss):
    scene = JaxScene(_tet_obj(JaxObjMesh))
    cam = OrbitCamera(W, H)
    fc = scene.update_frame(cam.eye, cam.view_proj, W, H)
    cfg = JaxConfig(grid_size=N, width=W, height=H, render_ss=ss)
    img = JaxFramePipeline(cfg, scene.buffers).frame(fc)
    return scene, fc, np.asarray(img)


@pytest.mark.parametrize("ss", [1, 2])
def test_frame_matches_jax_cpu_frame(ss):
    """FramePipeline.frame on identical state (the JAX mesh buffers carried
    across as numpy) within 2e-3 (the tet-golden bound) of the JAX frame."""
    jscene, fc, want = _jax_frame(ss)
    mesh = mesh_buffers_from_numpy(
        {f: np.asarray(getattr(jscene.buffers, f)) for f in MESH_FIELDS}, "cpu"
    )
    cfg = VoxelizerConfig(grid_size=N, width=W, height=H, render_ss=ss)
    got = FramePipeline(cfg, mesh).frame(fc)
    assert got.dtype == torch.float32 and got.shape == (H, W, 3)
    assert np.abs(got.numpy() - want).max() < 2e-3
    if ss == 1:
        gold = np.load(GOLDENS / "tet_32_render_96x64.npy").astype(np.float32)
        assert np.abs(got.numpy() - gold).max() < 2e-3


def test_render_fast_alias_and_light_volume_match_jax():
    """render takes "fast" as an alias of "warp" and a caller's light_volume
    in place of the sweep's, as the JAX package's render does; the images
    are within 2e-3 (the tet-golden bound) of JAX's on the same grid."""
    import jax.numpy as jnp

    from dxrvoxelizer_tpu.core.pipeline import VoxelGrid as JaxVoxelGrid
    from dxrvoxelizer_tpu.core.pipeline import render as jax_render
    from dxrvoxelizer_tpu.core.pipeline import voxelize as jax_voxelize

    jscene, fc, _ = _jax_frame(1)
    jgrid = jax_voxelize(jscene.buffers, N, impl="xla")
    grid = grid_from_numpy(np.asarray(jgrid.words), "cpu")
    cfg = VoxelizerConfig(grid_size=N, width=W, height=H, render_ss=1)
    jcfg = JaxConfig(grid_size=N, width=W, height=H, render_ss=1)
    warp = render(grid, fc, cfg)
    assert torch.equal(render(grid, fc, cfg, impl="fast"), warp)
    # a light field of the caller's: half the light everywhere
    rng = np.random.default_rng(4)
    lv = (rng.random((N, N, N)) * 0.5).astype(np.float32)
    got = render(grid, fc, cfg, impl="fast", light_volume=torch.from_numpy(lv))
    want = np.asarray(jax_render(JaxVoxelGrid(words=jgrid.words), fc, jcfg,
                                 impl="fast", light_volume=jnp.asarray(lv)))
    assert np.abs(got.numpy() - want).max() < 2e-3
    assert np.abs(got.numpy() - warp.numpy()).max() > 0.05  # it was used
    with pytest.raises(ValueError):
        render(grid, fc, cfg, light_volume=torch.zeros((N, N, N // 2)))


def test_scene_and_frame_constants_match_jax():
    jscene = JaxScene(_tet_obj(JaxObjMesh))
    scene = Scene(_tet_obj(ObjMesh), "cpu")
    for f in MESH_FIELDS:
        np.testing.assert_array_equal(
            getattr(scene.buffers, f).numpy(),
            np.asarray(getattr(jscene.buffers, f)), err_msg=f,
        )
    cam = OrbitCamera(W, H)
    a = jscene.update_frame(cam.eye, cam.view_proj, W, H)
    b = scene.update_frame(cam.eye, cam.view_proj, W, H)
    for f in ("local_space_light_pt", "local_space_eye_pt", "screen_to_local"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)


def test_grid_from_numpy_renders_like_the_pipeline():
    scene = Scene(_tet_obj(ObjMesh), "cpu")
    cfg = VoxelizerConfig(grid_size=N, width=W, height=H)
    cam = OrbitCamera(W, H)
    fc = scene.update_frame(cam.eye, cam.view_proj, W, H)
    pipe = FramePipeline(cfg, scene.buffers)
    img = pipe.frame(fc)
    from dxrvoxelizer_tpu.ops.packing import pack_bits_z
    from dxrvoxelizer_tpu.ops.voxelize_ref import voxelize_parity_ref

    jb = _jax_frame(2)[0].buffers
    words = np.asarray(pack_bits_z(voxelize_parity_ref(
        jb.positions_norm, jb.tris, n=N)))
    grid = grid_from_numpy(words, "cpu")
    assert torch.equal(render(grid, fc, cfg), img)
    with pytest.raises(ValueError):
        grid_from_numpy(words.astype(np.int64), "cpu")


def test_engine_slots_and_ring(tmp_path):
    scene = Scene(_tet_obj(ObjMesh), "cpu")
    cfg = VoxelizerConfig(grid_size=N, width=W, height=H, render_ss=1)
    eng = Engine(cfg, "cpu", scene=scene)
    cam = OrbitCamera(W, H)
    with pytest.raises(RuntimeError):
        eng.render(0)
    imgs = []
    for frame in range(FRAME_COUNT + 1):
        eng.update_frame(frame % FRAME_COUNT, cam.eye, cam.view_proj)
        imgs.append(eng.render(frame % FRAME_COUNT))
    eng.sync()
    assert all(torch.equal(i, imgs[0]) for i in imgs)  # same camera
    grid = eng.voxelize_only()
    fc = scene.update_frame(cam.eye, cam.view_proj, W, H)
    assert torch.equal(eng.render_grid(grid, fc), imgs[0])


class _Routed(Exception):
    """Raised by a stubbed accel builder: the call was routed to it."""


def _route_stub(name):
    def stub(*args, **kwargs):
        raise _Routed(name)
    return stub


def test_unported_options_raise(monkeypatch):
    """Every option of the JAX package's render now runs (mips, the point
    light, the gather and ref renderers, checked against JAX); the queue,
    deforming, ray-stab and -normals paths run (on the CPU through gen-1 and the MT oracle, at
    every n, deforming meshes included). On a GPU, ray-stab and -normals
    route as in the JAX package: gen-7 at n >= 128 (through the accel cache
    unless -noaccelcache), gen-6 below, and with -deform the gen-7 or gen-6
    refitter; the builders are stubbed here, so only the routing runs."""
    scene = Scene(_tet_obj(ObjMesh), "cpu")
    base = VoxelizerConfig(grid_size=N, width=W, height=H)
    cam = OrbitCamera(W, H)
    fc = scene.update_frame(cam.eye, cam.view_proj, W, H)
    for cfg in (base.replace(inside_mode="raystab"),
                base.replace(parity_normals=True)):
        FramePipeline(cfg.replace(grid_size=128), scene.buffers)  # the CPU: gen-1
        for deforming in (False, True):
            img = FramePipeline(cfg, scene.buffers, deforming=deforming).frame(fc)
            assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
    from dxrvoxelizer_tpu_torch.core.pipeline import voxelize
    from dxrvoxelizer_tpu_torch.models.mesh import MeshBuffers
    from dxrvoxelizer_tpu_torch.ops import (
        raystab_fast,
        raystab_refit,
        raystab_tiled,
    )
    from dxrvoxelizer_tpu_torch.utils import accel_cache

    for mod, fn, name in (
            (raystab_tiled, "build_raystab_accel7", "gen-7"),
            (raystab_fast, "build_raystab_accel2", "gen-6"),
            (accel_cache, "cached_build_raystab_accel7", "cached gen-7"),
            (accel_cache, "cached_build_raystab_accel2", "cached gen-6"),
            (raystab_tiled, "RaystabTiledRefitter", "gen-7 refit"),
            (raystab_refit, "RaystabRefitter", "gen-6 refit")):
        monkeypatch.setattr(mod, fn, _route_stub(name))
    mb = scene.buffers
    with pytest.raises(_Routed, match="^gen-7$"):
        raystab_fast.voxelize_raystab_fast(mb.positions_norm.to("meta"),
                                           mb.normals.to("meta"),
                                           mb.tris.to("meta"), n=128)
    # a mesh on the card (the routing reads only its device)
    monkeypatch.setattr(MeshBuffers, "device",
                        property(lambda self: torch.device("cuda")))
    for cfg in (base.replace(inside_mode="raystab"),
                base.replace(parity_normals=True)):
        for n, gen in ((128, "gen-7"), (N, "gen-6")):
            c = cfg.replace(grid_size=n)
            for c_, deforming, want in (
                    (c, False, f"cached {gen}"),
                    (c.replace(accel_cache=False), False, gen),
                    (c, True, f"{gen} refit"),
                    (c.replace(deform_pad=0.0), True, f"cached {gen}")):
                with pytest.raises(_Routed, match=f"^{want}$"):
                    FramePipeline(c_, mb, deforming=deforming).frame(fc)
    with pytest.raises(_Routed, match="^gen-7$"):
        voxelize(mb, 128, with_normals=True, impl="xla")
    monkeypatch.undo()
    # the render variants match the JAX package's render on the same grid:
    # shear-warp at the tet-golden bound (2e-3), the gather renderer and the
    # oracle within 1e-5
    import jax.numpy as jnp

    from dxrvoxelizer_tpu.core.pipeline import VoxelGrid as JaxVoxelGrid
    from dxrvoxelizer_tpu.core.pipeline import render as jax_render

    g = voxelize(scene.buffers, N)
    jg = JaxVoxelGrid(words=jnp.asarray(g.words.numpy()))
    ref_kw = {"num_samples": 32, "num_light_samples": 8}
    for kw, impl, tol in (({"show_mip": 1}, "warp", 2e-3),
                          ({"point_light": True}, "warp", 2e-3),
                          ({}, "gather", 1e-5), (ref_kw, "ref", 1e-5)):
        got = render(g, fc, base.replace(**kw), impl=impl)
        want = np.asarray(jax_render(
            jg, fc, JaxConfig(grid_size=N, width=W, height=H, **kw), impl=impl))
        assert np.abs(got.numpy() - want).max() <= tol, (kw, impl)
    want = render(voxelize(scene.buffers, N, impl="xla"), fc, base)
    for kw in ({"vox_impl": "queue"}, {"deforming": True},
               {"deforming": True, "vox_impl": "queue"}):
        assert torch.equal(FramePipeline(base, scene.buffers, **kw).frame(fc),
                           want), kw


def _write_obj(path, verts, tris):
    lines = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in verts]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in tris]
    path.write_text("\n".join(lines) + "\n")


def test_app_warp_writes_png(tmp_path, monkeypatch):
    from dxrvoxelizer_tpu_torch.app.main import main

    v, _, t = icosphere_mesh(2)
    _write_obj(tmp_path / "ico.obj", v, t)
    monkeypatch.chdir(tmp_path)  # the CLI reads "/..." as a flag
    rc = main(["-mesh", "ico.obj", "-warp", "-grid", "32", "-frames", "2",
               "-width", "96", "-height", "64", "-out", "out.png"])
    assert rc == 0
    img = read_png(tmp_path / "out.png")
    assert img.shape == (64, 96, 3)
    assert (img != np.array([0, 51, 102], np.uint8)).any()  # not all clear
    mesh = load_obj(tmp_path / "ico.obj")
    assert mesh.num_triangles == len(t)


def test_python_m_app_runs(tmp_path):
    v, _, t = icosphere_mesh(1)
    _write_obj(tmp_path / "ico.obj", v, t)
    res = subprocess.run(
        [sys.executable, "-m", "dxrvoxelizer_tpu_torch.app", "-mesh", "ico.obj",
         "-warp", "-grid", "32", "-frames", "1", "-width", "48", "-height",
         "32", "-out", "m.png"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={**os.environ,
             "PYTHONPATH": str(Path(__file__).resolve().parents[1])},
    )
    assert res.returncode == 0, res.stderr
    assert (tmp_path / "m.png").is_file() and "wrote m.png" in res.stdout


def test_jax_and_port_load_the_same_obj(tmp_path):
    from dxrvoxelizer_tpu.utils.objloader import load_obj as jax_load_obj

    v, _, t = icosphere_mesh(2)
    _write_obj(tmp_path / "ico.obj", v, t)
    a = jax_load_obj(tmp_path / "ico.obj", impl="python")
    b = load_obj(tmp_path / "ico.obj")
    for f in ("positions", "normals", "indices", "aabb_min", "aabb_max"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
