"""The app shell of the CUDA build on the CPU: the Engine's alternate
(X-key) pipeline against the JAX package's, the interactive loop, the live
preview server, the profiling utilities, and the app's flags (``-renderimpl
-showmip -usemutex -pointlight -ab -timings -profile -savegrid -loadgrid
-interactive -preview -chips``) through its ``main``. Mirrors the JAX
package's tests/test_interactive.py, test_preview.py and test_profiling.py."""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dxrvoxelizer_tpu_torch.app import interactive
from dxrvoxelizer_tpu_torch.app.main import main
from dxrvoxelizer_tpu_torch.app.preview import PreviewServer, _free_port
from dxrvoxelizer_tpu_torch.ez import Engine
from dxrvoxelizer_tpu_torch.models.camera import OrbitCamera
from dxrvoxelizer_tpu_torch.models.scene import Scene
from dxrvoxelizer_tpu_torch.utils.config import VoxelizerConfig
from dxrvoxelizer_tpu_torch.utils.image import encode_png, read_png
from dxrvoxelizer_tpu_torch.utils.objloader import ObjMesh
from dxrvoxelizer_tpu_torch.utils.profiling import (
    PassTimers,
    device_trace,
    pass_scope,
)
from tests.meshes import icosphere_mesh, tetrahedron_mesh

torch.set_num_threads(2)

CLEAR_U8 = np.array([0, 51, 102], np.uint8)


def _obj(cls, v, nrm, t):
    v = np.asarray(v, np.float32)
    return cls(positions=v, normals=np.asarray(nrm, np.float32),
               indices=np.asarray(t, np.int32).reshape(-1),
               aabb_min=v.min(axis=0), aabb_max=v.max(axis=0))


def _tet_engine(**cfg_kw):
    cfg = VoxelizerConfig(grid_size=32, width=64, height=64, **cfg_kw)
    return Engine(cfg, "cpu", scene=Scene(_obj(ObjMesh, *tetrahedron_mesh()),
                                          "cpu"),
                  vox_impl="xla", render_impl="gather")


def _ico_world():
    v, nrm, t = icosphere_mesh(2, radius=0.6)
    return np.asarray(v, np.float32) * 2.0 + np.array([0, 4, 0], np.float32), nrm, t


# ---- the Engine's alternate pipeline ---------------------------------------

def test_engine_alt_pipeline_matches_jax():
    """toggle_path swaps voxelize AND render to the alternate pipeline (the
    counting oracle + the gather renderer); over 3 orbiting frames its
    images are within 1e-5 of the JAX package's alternate frames, the
    primary (shear-warp) frames within 2e-3 (the tet-golden bound)."""
    from dxrvoxelizer_tpu.ez import Engine as JaxEngine
    from dxrvoxelizer_tpu.models.scene import Scene as JaxScene
    from dxrvoxelizer_tpu.utils.config import VoxelizerConfig as JaxConfig
    from dxrvoxelizer_tpu.utils.objloader import ObjMesh as JaxObjMesh

    w = _ico_world()
    cfg = dict(grid_size=32, width=48, height=32)
    jeng = JaxEngine(JaxConfig(**cfg), scene=JaxScene(_obj(JaxObjMesh, *w)),
                     vox_impl="xla")
    eng = Engine(VoxelizerConfig(**cfg), "cpu",
                 scene=Scene(_obj(ObjMesh, *w), "cpu"), vox_impl="xla")
    cam = OrbitCamera(48, 32)
    for alt in (False, True):
        if alt:
            assert jeng.toggle_path() and eng.toggle_path()
            assert eng.pipeline_alt.vox_impl == "xla"
            assert eng.pipeline_alt.render_impl == "gather"
        for frame in range(3):
            if frame:
                cam.orbit(120.0, 0.0)
            jeng.update_frame(frame, cam.eye, cam.view_proj)
            eng.update_frame(frame, cam.eye, cam.view_proj)
            want = np.asarray(jeng.render(frame))
            got = eng.render(frame).numpy()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 if alt else 2e-3)
    eng.sync()
    assert not eng.toggle_path()
    grid = eng.voxelize_only()
    assert eng.last_grid is grid and grid.n == 32


def test_engine_dual_pipeline_images_agree():
    """The two complete pipelines (primary shear-warp vs oracle + gather
    alternate) render the same scene within mean 0.03 and p99 0.35, the
    reference's visual Core/EZ equivalence (DXRVoxelizer.cpp:295-297)."""
    w = _ico_world()
    cfg = VoxelizerConfig(grid_size=32, width=64, height=64)
    eng = Engine(cfg, "cpu", scene=Scene(_obj(ObjMesh, *w), "cpu"),
                 vox_impl="xla", render_impl="warp")
    cam = OrbitCamera(64, 64)
    eng.update_frame(0, cam.eye, cam.view_proj)
    primary = eng.render(0).numpy()
    assert eng.toggle_path()
    alt = eng.render(0).numpy()
    eng.sync()
    diff = np.abs(primary - alt)
    assert diff.mean() < 0.03, diff.mean()
    assert np.percentile(diff, 99) < 0.35


# ---- interactive loop (JAX tests/test_interactive.py) ----------------------

class _KeyFeed:
    """Scripted key source standing in for the TTY."""

    def __init__(self, keys):
        self.keys = list(keys)
        self.enabled = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def poll_key(self):
        return self.keys.pop(0) if self.keys else None


def test_headless_loop_renders_frames():
    eng = _tet_engine()
    assert interactive.run_interactive(eng, OrbitCamera(64, 64),
                                       max_frames=3) == 3


def test_hotkeys_pause_switch_quit(monkeypatch, capsys):
    eng = _tet_engine()
    # pause, resume, switch the full pipeline, render a frame on the
    # alternate path, switch back, then quit
    feed = _KeyFeed([" ", " ", "x", None, "x", None, "q"])
    monkeypatch.setattr(interactive, "_RawTTY", lambda: feed)
    n = interactive.run_interactive(eng, OrbitCamera(64, 64), max_frames=10)
    out = capsys.readouterr().out
    assert "paused" in out and "resumed" in out
    assert "pipeline -> alt" in out and "pipeline -> primary" in out
    assert eng._pipeline_alt is not None  # the alt pipeline rendered
    assert not eng.use_alt
    assert n < 10  # quit before exhausting frames


def test_screenshot_key(monkeypatch, tmp_path):
    eng = _tet_engine()
    monkeypatch.setattr(interactive, "_RawTTY", lambda: _KeyFeed(["s"]))
    monkeypatch.chdir(tmp_path)
    interactive.run_interactive(eng, OrbitCamera(64, 64), max_frames=2)
    shots = list(tmp_path.glob("*.png"))
    assert shots and read_png(shots[0]).shape == (64, 64, 3)


def test_hotkeys_orbit_zoom(monkeypatch, capsys):
    """hjkl orbit + o auto-orbit toggle move/steady the camera."""
    eng = _tet_engine()
    cam = OrbitCamera(64, 64)
    eye0 = cam.eye.copy()
    feed = _KeyFeed(["o", "h", "j", "+", None, "q"])
    monkeypatch.setattr(interactive, "_RawTTY", lambda: feed)
    interactive.run_interactive(eng, cam, max_frames=10)
    assert "auto-orbit off" in capsys.readouterr().out
    assert not np.allclose(cam.eye, eye0)
    assert np.linalg.norm(cam.eye - cam.focus) < np.linalg.norm(eye0 - cam.focus)


def test_interactive_publishes_tensor_frames_to_preview():
    """With a viewer waiting, the loop hands the preview its frames as
    tensors; the server copies each to numpy once."""
    eng = _tet_engine()
    srv = PreviewServer(port=0)
    try:
        got = {}

        def fetch():
            r = urllib.request.urlopen(srv.url + "frame.png?after=0", timeout=20)
            got["seq"] = int(r.headers["X-Frame-Seq"])
            got["png"] = r.read()

        t = threading.Thread(target=fetch)
        t.start()
        deadline = time.monotonic() + 10
        while not srv.wants_frame() and time.monotonic() < deadline:
            time.sleep(0.01)
        interactive.run_interactive(eng, OrbitCamera(64, 64), max_frames=2,
                                    preview=srv)
        t.join(timeout=20)
        assert got["seq"] >= 1 and got["png"][:4] == b"\x89PNG"
        assert isinstance(srv._frame, np.ndarray)
        assert srv._frame.shape == (64, 64, 3)
    finally:
        srv.close()


# ---- live preview (JAX tests/test_preview.py) -------------------------------

def test_encode_png_roundtrip(tmp_path):
    img = np.random.default_rng(7).integers(0, 256, size=(9, 13, 3),
                                            dtype=np.uint8)
    p = tmp_path / "x.png"
    p.write_bytes(encode_png(img))
    np.testing.assert_array_equal(read_png(p), img)


def test_preview_serves_published_frame(tmp_path):
    srv = PreviewServer(port=0)
    try:
        page = urllib.request.urlopen(srv.url, timeout=5).read()
        assert b"frame.png" in page
        img = np.zeros((8, 16, 3), np.uint8)
        img[2, 3] = (255, 128, 1)
        srv.publish(torch.from_numpy(img))  # a tensor, as the loop gives it
        r = urllib.request.urlopen(srv.url + "frame.png?after=-1", timeout=5)
        assert r.status == 200 and int(r.headers["X-Frame-Seq"]) == 1
        p = tmp_path / "got.png"
        p.write_bytes(r.read())
        np.testing.assert_array_equal(read_png(p), img)
    finally:
        srv.close()


def test_preview_long_poll_wakes_on_publish():
    srv = PreviewServer(port=0)
    try:
        srv.publish(np.zeros((4, 4, 3), np.uint8))
        got = {}

        def fetch():
            # a frame NEWER than seq 1 -> blocks until publish #2
            r = urllib.request.urlopen(srv.url + "frame.png?after=1", timeout=10)
            got["seq"] = int(r.headers["X-Frame-Seq"])

        t = threading.Thread(target=fetch)
        t.start()
        deadline = time.monotonic() + 5
        while not srv.wants_frame() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert srv.wants_frame()
        srv.publish(np.ones((4, 4, 3), np.uint8))
        t.join(timeout=10)
        assert got.get("seq") == 2
    finally:
        srv.close()


def _post_json(url, obj):
    req = urllib.request.Request(
        url, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    return urllib.request.urlopen(req, timeout=5)


def test_preview_input_route_drains_to_camera():
    """POST /input events queue and drain into the orbit camera (the
    reference's WM_MOUSEMOVE/WM_MOUSEWHEEL path, DXRVoxelizer.cpp:301-356)."""
    srv = PreviewServer(port=0)
    try:
        assert _post_json(srv.url + "input", {"dx": 24.0, "dy": -8.0}).status == 204
        assert _post_json(srv.url + "input", [{"wheel": 2.0}]).status == 204
        cam = OrbitCamera(640, 360)
        eye0 = np.asarray(cam.eye).copy()
        dist0 = float(np.linalg.norm(np.asarray(cam.eye)))
        assert srv.apply_camera_inputs(cam)
        assert not np.allclose(np.asarray(cam.eye), eye0)  # drag orbited
        assert float(np.linalg.norm(np.asarray(cam.eye))) < dist0  # zoomed in
        assert srv.poll_inputs() == []  # drained
    finally:
        srv.close()


def test_preview_input_route_rejects_garbage():
    srv = PreviewServer(port=0)
    try:
        req = urllib.request.Request(srv.url + "input", data=b"not json",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=5)
        assert e.value.code == 400
        page = urllib.request.urlopen(srv.url, timeout=5).read()
        assert b"/input" in page and b"pointermove" in page
    finally:
        srv.close()


def test_preview_float_frame_stats_and_free_port():
    srv = PreviewServer(port=_free_port())
    try:
        srv.publish(torch.full((4, 4, 3), 0.5))  # float [0,1] tensor
        r = urllib.request.urlopen(srv.url + "stats.json", timeout=5)
        assert json.loads(r.read())["seq"] == 1
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(srv.url + "nothing", timeout=5)
    finally:
        srv.close()


# ---- profiling (JAX tests/test_profiling.py) --------------------------------

def test_pass_timers_aggregate():
    t = PassTimers()
    for _ in range(3):
        with t.measure("voxelize"):
            torch.ones((64, 64)).sum()
        with t.measure("raycast"):
            pass
    s = t.summary()
    assert set(s) == {"voxelize", "raycast"}
    assert t.counts["voxelize"] == 3
    assert all(v >= 0 for v in s.values())
    t.reset()
    assert not t.summary()


def test_pass_scope_lands_in_the_trace(tmp_path):
    """A pass scope is a named range of the profiler's trace, and
    device_trace writes that trace as a Chrome trace into its directory."""
    with device_trace(str(tmp_path / "prof")) as prof:
        with pass_scope("scoped_pass"):
            x = torch.ones(8) * 2
    assert float(x.sum()) == 16.0
    assert "scoped_pass" in {e.key for e in prof.key_averages()}
    traces = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert "scoped_pass" in names


def test_step_timer_fixed_timestep_catchup():
    """Fixed-timestep mode (StepTimer.h:104-133): updates fire once per
    whole target interval with catch-up, and leftover time carries over."""
    from dxrvoxelizer_tpu_torch.utils.timer import StepTimer

    t = StepTimer()
    t.is_fixed_time_step = True
    t.target_elapsed_seconds = 0.01
    calls = []
    t._last = time.perf_counter() - 0.035  # a 35 ms gap: 3 updates + 5 ms
    t.tick(lambda: calls.append(1))
    assert len(calls) == 3
    assert abs(t._leftover - 0.005) < 2e-3
    assert t.frame_count == 3


# ---- the app's flags through main -------------------------------------------

def _write_obj(path, verts, tris):
    lines = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in verts]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in tris]
    path.write_text("\n".join(lines) + "\n")


@pytest.fixture
def ico_dir(tmp_path, monkeypatch):
    """A temporary working directory holding ico.obj: the CLI reads a
    leading "/" as a flag (the reference's prefixes), so -mesh takes a
    relative path."""
    v, _, t = icosphere_mesh(2)
    # at the default camera's focus, the reference bunny's footprint
    _write_obj(tmp_path / "ico.obj", v * 5.5 + np.array([0.0, 4.0, 0.0]), t)
    monkeypatch.chdir(tmp_path)
    return tmp_path


BASE = ["-mesh", "ico.obj", "-warp", "-grid", "32", "-width", "48",
        "-height", "32", "-frames", "2"]


def test_engine_and_scene_take_the_jax_signatures(ico_dir, monkeypatch):
    """Engine(cfg), Engine(cfg, scene=...), Engine(cfg, scene) and
    Scene.load(cfg), called as the JAX package calls them, resolve a -warp
    config to the CPU and render the frame of Engine(cfg, "cpu", scene=...);
    without -warp they ask for the card (and raise here, without one)."""
    from dxrvoxelizer_tpu_torch.utils.config import parse_args

    cfg = parse_args(BASE)
    assert cfg.backend == "cpu"
    scene = Scene.load(cfg)
    assert scene.buffers.device == torch.device("cpu")
    engines = [Engine(cfg, "cpu", scene=Scene.load(cfg, "cpu")),
               Engine(cfg, scene=scene), Engine(cfg), Engine(cfg, scene),
               Engine(cfg, scene=scene, device="cpu")]
    cam = OrbitCamera(cfg.width, cfg.height)
    frames = []
    for eng in engines:
        assert eng.device == torch.device("cpu")
        eng.update_frame(0, cam.eye, cam.view_proj)
        frames.append(eng.render(0))
        eng.sync()
    for f in frames[1:]:
        assert torch.equal(f, frames[0])
    with pytest.raises(ValueError, match="the scene lies on cpu"):
        Engine(cfg, scene=scene, device="cuda")
    with pytest.raises(TypeError, match="scene given twice"):
        Engine(cfg, scene, scene=scene)
    card = cfg.replace(backend="default")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: Engine(card), lambda: Scene.load(card),
                 lambda: Scene(scene.obj)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.parametrize("extra", [
    ["-renderimpl", "gather"],
    ["-renderimpl", "ref", "-width", "24", "-height", "16"],
    ["-showmip", "1"],
    ["-showmip", "2", "-usemutex"],
    ["-pointlight"],
    ["-pointlight", "-renderimpl", "gather"],
], ids=lambda e: " ".join(e))
def test_app_render_flags(ico_dir, extra):
    """Each renderer and render switch runs through the app and writes a
    frame with the volume in it."""
    rc = main([*BASE, *extra, "-out", "f.png"])
    assert rc == 0
    img = read_png(ico_dir / "f.png")
    w, h = (24, 16) if "ref" in extra else (48, 32)
    assert img.shape == (h, w, 3)
    assert (np.abs(img.astype(int) - CLEAR_U8).sum(-1) > 3).mean() > 0.05


def test_app_hq_light_step_below_one_slab(ico_dir, monkeypatch):
    """-hq on a grid where the light step spans less than one slab (d0 =
    0): packed grids are multiples of 32, so the app reaches it through a
    mip level (-showmip 2 at 32^3 renders the 8^3 level), and the light
    field is the exact per-voxel one (precompute_light_volume), once per
    frame."""
    from dxrvoxelizer_tpu_torch.ops import raymarch_warp

    calls = []
    real = raymarch_warp.precompute_light_volume

    def counted(density, *a, **kw):
        calls.append(density.shape[0])
        return real(density, *a, **kw)

    monkeypatch.setattr(raymarch_warp, "precompute_light_volume", counted)
    assert main([*BASE, "-showmip", "2", "-hq", "-out", "f.png"]) == 0
    assert calls == [8, 8]
    img = read_png(ico_dir / "f.png")
    assert (np.abs(img.astype(int) - CLEAR_U8).sum(-1) > 3).mean() > 0.05


def test_app_ab_exits_zero_and_fails_on_a_mismatch(ico_dir, capsys, monkeypatch):
    """-ab: the voxelizer's paths bit for bit, then the shear-warp and
    gather pipelines' images within mean 0.03 / p99 0.35 -> exit 0; a
    gather image far off -> exit 1."""
    assert main([*BASE, "-ab", "-out", "f.png"]) == 0
    out = capsys.readouterr().out
    assert "A/B voxelizer paths identical: True" in out
    assert "-> OK" in out
    from dxrvoxelizer_tpu_torch.core import pipeline

    real = pipeline.render

    def dark_gather(grid, consts, cfg, impl="warp", **kw):
        img = real(grid, consts, cfg, impl=impl, **kw)
        return img * 0.0 if impl == "gather" else img

    monkeypatch.setattr(pipeline, "render", dark_gather)
    assert main([*BASE, "-ab", "-out", "g.png"]) == 1
    assert "-> FAIL" in capsys.readouterr().out


def test_app_timings_and_profile(ico_dir, capsys):
    """-timings prints three fenced voxelize / raycast passes; -profile DIR
    writes a Chrome trace of the frame loop into DIR."""
    assert main([*BASE, "-timings", "-profile", "prof", "-out", "f.png"]) == 0
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("pass timings"))
    assert "'voxelize'" in line and "'raycast'" in line
    traces = list((ico_dir / "prof").glob("trace_*.json"))
    assert len(traces) == 1 and json.loads(traces[0].read_text())["traceEvents"]


def test_app_savegrid_loadgrid_roundtrip(ico_dir):
    """-savegrid writes the occupancy grid; -loadgrid renders it (boolean
    occupancy or packed words) without re-voxelizing, the same image as
    rendering the voxelized grid."""
    from dxrvoxelizer_tpu_torch.core.pipeline import render, voxelize
    from dxrvoxelizer_tpu_torch.ops.packing import pack_bits_z

    assert main([*BASE, "-renderimpl", "gather", "-savegrid", "g.npy",
                 "-out", "first.png"]) == 0
    occ = np.load(ico_dir / "g.npy")
    assert occ.dtype == bool and occ.shape == (32, 32, 32) and occ.any()
    np.save(ico_dir / "w.npy", pack_bits_z(torch.from_numpy(occ)).numpy())
    for path, png in (("g.npy", "r.png"), ("w.npy", "rw.png")):
        assert main([*BASE, "-renderimpl", "gather", "-loadgrid", path,
                     "-out", png]) == 0
    a, b = read_png(ico_dir / "r.png"), read_png(ico_dir / "rw.png")
    np.testing.assert_array_equal(a, b)
    eng = Engine(VoxelizerConfig(mesh="ico.obj", grid_size=32, width=48,
                                 height=32), "cpu", vox_impl="xla")
    cam = OrbitCamera(48, 32)
    fc = eng.scene.update_frame(cam.eye, cam.view_proj, 48, 32)
    grid = voxelize(eng.scene.buffers, 32, impl="xla")
    assert torch.equal(grid.occupancy(), torch.from_numpy(occ))
    want = render(grid, fc, eng.cfg, impl="gather").numpy()
    from dxrvoxelizer_tpu_torch.utils.image import to_u8

    np.testing.assert_array_equal(a, to_u8(want))


def test_app_interactive_and_preview_flags(ico_dir, capsys):
    """-interactive runs the hotkey loop headless for -frames; -preview
    [PORT] serves the live view and closes it at the end."""
    assert main([*BASE, "-interactive"]) == 0
    assert "rendered 2 frames" in capsys.readouterr().out
    assert main([*BASE, "-preview", str(_free_port()), "-out", "p.png"]) == 0
    out = capsys.readouterr().out
    url = next(ln.split()[-1] for ln in out.splitlines()
               if ln.startswith("live preview:"))
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(url, timeout=2)  # closed with the run
    assert (ico_dir / "p.png").is_file()


def test_app_chips_raises_and_names_item_7():
    """-chips N (ROADMAP item 7, ported) on the card by default: without
    cards it raises before loading anything, never falling back to the CPU
    (``-chips 2 -warp`` runs gloo ranks: tests/test_torch_parallel.py)."""
    with pytest.raises(ValueError, match="requested 2 devices, found 0"):
        main(["-mesh", "never_loaded.obj", "-chips", "2"])
