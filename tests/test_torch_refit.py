"""Deforming ray-stab in the CUDA build against the JAX package on the CPU:
the deformation-padded binning, the gen-6 and gen-7 refitters, their
contract check, the on-disk accel cache and the CPU's deforming frame.

The padded cone keys, capsules and compacts equal JAX's bit for bit (the
same numpy calls). A refitted accel's queries equal a fresh build's on the
deformed mesh and the radial oracle bit for bit (the fold's plain version
on the CPU). The CPU's deforming ``-inside raystab`` frame rebuilds gen-1
when the mesh changes, as JAX's CPU frame does; its grids equal JAX's.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dxrvoxelizer_tpu.core.pipeline as jpl
import dxrvoxelizer_tpu.ops.raystab_fast as jrf
import dxrvoxelizer_tpu.ops.raystab_tiled as jt
import dxrvoxelizer_tpu.ops.voxelize_ref as jvr
from dxrvoxelizer_tpu.models.mesh import MeshBuffers as JaxMeshBuffers
from dxrvoxelizer_tpu.utils import accel_cache as jac
from dxrvoxelizer_tpu.utils.config import VoxelizerConfig as JaxConfig
from benchmark import work
from dxrvoxelizer_tpu_torch.core import pipeline as ppl
from dxrvoxelizer_tpu_torch.models.mesh import MeshBuffers
from dxrvoxelizer_tpu_torch.ops import raystab_cuda as rc
from dxrvoxelizer_tpu_torch.ops import raystab_fast as rf
from dxrvoxelizer_tpu_torch.ops import raystab_refit as rr
from dxrvoxelizer_tpu_torch.ops import raystab_tiled as rt
from dxrvoxelizer_tpu_torch.ops import voxelize_ref as vr
from dxrvoxelizer_tpu_torch.state import (
    raystab_compact7_from_numpy,
    raystab_compact_from_numpy,
)
from dxrvoxelizer_tpu_torch.utils import accel_cache as ac
from dxrvoxelizer_tpu_torch.utils.config import VoxelizerConfig, parse_args
from tests.meshes import box_mesh, icosphere_mesh
from tests.torch_cases import assert_folds_equal
from tests.test_torch_raystab1 import jax_python_path  # noqa: F401 (fixture)

torch.set_num_threads(2)

N = 32
PAD = 0.035  # the app's default (utils/config.py: deform_pad)


def _sphere():
    """A 320-triangle icosphere with three degenerate triangles appended
    (a deformation can give them area: padded builds keep them)."""
    v, nr, t = icosphere_mesh(2, radius=0.7)
    t = np.concatenate([t, [[0, 0, 1], [2, 2, 2], [3, 4, 3]]])
    return (np.asarray(v, np.float32), np.asarray(nr, np.float32),
            np.asarray(t, np.int32))


def _wobble(v, nr, frame):
    """The app's -deform wobble (app/main.py ``wobbled``) in numpy f32."""
    amp = 0.03 * np.sin(2 * np.pi * frame / 15.0 + v[:, :1] * 5.0)
    return (v + amp.astype(np.float32) * nr).astype(np.float32)


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i" else a)


def _same(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


# ---- the padded binning ---------------------------------------------------------

def test_capsule_params_and_seg_origin_dist_match_jax():
    v, nr, t = _sphere()
    got = rf._capsule_params(v, t, PAD, nr * np.float32(1.5))
    want = jrf._capsule_params(v, t, PAD, nr * np.float32(1.5))
    assert all(_same(a, b) for a, b in zip(got, want))
    p = v[t[:, 0]] - got[0]
    q = v[t[:, 1]] + got[0]
    assert _same(rf._seg_origin_dist(p, q), jrf._seg_origin_dist(p, q))


@pytest.mark.parametrize("pad,dirs", [(0.0, False), (PAD, False), (PAD, True)])
@pytest.mark.parametrize("g", [32, 8])
def test_padded_cone_keys_match_jax(pad, dirs, g):
    v, nr, t = _sphere()
    d = nr if dirs else None
    got = rf._cone_keys_np(v, t, g, rf.SPAN, pad, d)
    want = jrf._cone_keys_np(v, t, g, rf.SPAN, pad, d)
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    # degenerate triangles reach the overflow only when padded
    assert bool(got[1][-3:].any()) == (pad > 0)
    assert _same(rt._tri_maxr(v, t, pad), jt._tri_maxr(v, t, pad))
    assert _same(rf._tri_minr(v, t, pad, d), jt._tri_minr(v, t, pad, d))


@pytest.mark.parametrize("dirs", [False, True])
def test_padded_compact2_matches_jax(jax_python_path, dirs):  # noqa: F811
    v, nr, t = _sphere()
    d = nr if dirs else None
    jc = jrf.build_raystab_compact2(jnp.asarray(v), jnp.asarray(t), N, pad=PAD,
                                    pad_dirs=d)
    pc = rf.build_raystab_compact2(_t(v), _t(t), N, pad=PAD,
                                   pad_dirs=None if d is None else _t(d))
    conv = raystab_compact_from_numpy(N, jc.classes, jc.ov_ids, jc.stats.levels,
                                      jc.stats.near_origin)
    assert len(pc.classes) == len(conv.classes)
    for a, b in zip(pc.classes, conv.classes):
        assert _same(a[0], b[0]) and _same(a[1], b[1])
        assert (a[2] is None) == (b[2] is None)
        assert a[2] is None or _same(a[2], b[2])
    assert _same(pc.ov_ids, conv.ov_ids) and pc.stats == conv.stats


@pytest.mark.parametrize("dirs", [False, True])
def test_padded_compact7_matches_jax(dirs):
    v, nr, t = _sphere()
    d = nr if dirs else None
    jc = jt.build_raystab_compact7(jnp.asarray(v), jnp.asarray(t), N, pad=PAD,
                                   pad_dirs=d)
    pc = rt.build_raystab_compact7(_t(v), _t(t), N, pad=PAD,
                                   pad_dirs=None if d is None else _t(d))
    conv = raystab_compact7_from_numpy(N, jc.classes, g_fine=jc.stats.g_fine,
                                       near_origin=jc.stats.near_origin)
    for k in ("tids", "offs", "ids"):
        assert torch.equal(getattr(pc, k), getattr(conv, k)), k
    assert (pc.bounds is None) == (conv.bounds is None)
    assert pc.bounds is None or torch.equal(pc.bounds, conv.bounds)
    assert pc.stats == conv.stats


# ---- the refitters --------------------------------------------------------------

REFITTERS = {"gen-6": (rr.RaystabRefitter, rf.build_raystab_accel2,
                       rf.raystab_query2),
             "gen-7": (rt.RaystabTiledRefitter, rt.build_raystab_accel7,
                       rt.raystab_query7)}


@pytest.mark.parametrize("dirs", [True, False])
@pytest.mark.parametrize("gen", list(REFITTERS))
def test_refit_matches_fresh_build_and_oracle(gen, dirs):
    """Two wobbled frames: the refitted accel's query equals a fresh build's
    on the deformed mesh and the radial oracle, both rules; only the rows
    change (rays, candidate runs and bounds are the rest build's)."""
    cls, build, query = REFITTERS[gen]
    v, nr, t = _sphere()
    rfit = cls(_t(v), _t(t), _t(nr), N, pad=PAD,
               pad_dirs=_t(nr) if dirs else None)
    rest = rfit.rest_accel
    for frame in (3, 11):
        vd = _t(_wobble(v, nr, frame))
        accel = rfit.refit(vd, check=True)
        assert accel.main.rays is rest.main.rays
        assert accel.main.cand_off is rest.main.cand_off
        assert accel.main.bounds is rest.main.bounds
        fresh = build(vd, _t(t), _t(nr), n=N)
        for rule in ("backface", "hit"):
            got, want = query(accel, rule=rule), query(fresh, rule=rule)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            ref = vr.voxelize_raystab_radial_ref(vd, _t(nr), _t(t), n=N, rule=rule)
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
            assert bool(got[0].any())
    # the rows of the rest pose, refitted, are the rest build's
    again = rfit.refit(_t(v))
    assert torch.equal(rc.candidate_rows(again.main), rc.candidate_rows(rest.main))
    with pytest.raises(ValueError, match="zero-pad"):
        cls(_t(v), _t(t), _t(nr), N, pad=0.0)


def _sphere_near_origin():
    """:func:`_sphere` with a small triangle about the origin appended: gen-6
    gives it the near-origin stream ("ov"), gen-7 every tile's candidates."""
    v, nr, t = _sphere()
    tri = np.array([[-0.04, -0.03, 0.01], [0.05, -0.02, -0.01],
                    [0.0, 0.05, 0.02]], np.float32)
    up = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (3, 1))
    t2 = np.arange(3, dtype=np.int32)[None] + v.shape[0]
    return (np.concatenate([v, tri]), np.concatenate([nr, up]),
            np.concatenate([t, t2]).astype(np.int32))


@pytest.mark.parametrize("gen", list(REFITTERS))
def test_refit_reads_rows_through_ids(gen):
    """A refit gathers no rows: each refitted stream holds the frame's fused
    matrix and the rest build's int32 row ids (the same tensor every frame),
    and no ``aten::index_select`` runs in it (the op benchmark/run.py reads
    as the refit's row gather). The plain kernels on it equal those on the
    rows it stands for, bit for bit, whole, through strip_slice and on
    benchmark/work.py's sub-tables (``raystab_work``); its query equals
    JAX's radial oracle run op by op on the deformed mesh."""
    cls, _, query = REFITTERS[gen]
    v, nr, t = _sphere_near_origin()
    rfit = cls(_t(v), _t(t), _t(nr), N, pad=PAD, pad_dirs=_t(nr))
    assert set(rfit._ids) == ({"main", "ov"} if gen == "gen-6" else {"main"})
    vd = _t(_wobble(v, nr, 5))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        accel = rfit.refit(vd)
    assert "aten::index_select" not in {e.name for e in prof.events()}
    fused = rf._fused_coef_matrix(vd, _t(t), _t(nr))
    tc = int(t.shape[0])
    for f, ids in rfit._ids.items():
        tb = getattr(accel, f)
        assert tb.row_ids is ids is getattr(rfit.rest_accel, f).row_ids
        assert ids.dtype == torch.int32 and torch.equal(tb.rows, fused)
        rows = dataclasses.replace(tb, rows=rc.candidate_rows(tb), row_ids=None)
        assert torch.equal(rows.rows, fused[ids.long()])
        for rule in ("backface", "hit"):
            assert_folds_equal(tb, rows, tc, rule)
        assert work.raystab_work(tb) == work.raystab_work(rows)
    with jax.disable_jit():
        want = jvr.voxelize_raystab_radial_ref(
            jnp.asarray(vd.numpy()), jnp.asarray(nr), jnp.asarray(t), n=N)
    got = query(accel)
    assert _same(got[0].numpy(), want[0]) and _same(got[1].numpy(), want[1])
    assert bool(got[0].any())


@pytest.mark.parametrize("gen", list(REFITTERS))
def test_refitter_checks_its_row_ids(gen, monkeypatch):
    """The refitter holds its row ids to the fused matrix's range once, at
    build (the kernel reads through them unchecked)."""
    cls = REFITTERS[gen][0]
    mod, name = (rf, "stream_ids2") if gen == "gen-6" else (rt, "stream_ids7")
    real = getattr(mod, name)
    v, nr, t = _sphere()
    monkeypatch.setattr(mod, name, lambda c, d: {
        k: ids + len(t) for k, ids in real(c, d).items()})
    with pytest.raises(ValueError, match="row ids outside"):
        cls(_t(v), _t(t), _t(nr), N, pad=PAD)


@pytest.mark.parametrize("dirs", [True, False])
def test_contract_checks_raise_as_jax(dirs):
    """The contract check passes the wobble and raises JAX's own messages on
    a displacement past the pad (isotropic) or a parameter |s| past it
    (directional) and on an off-axis displacement (directional)."""
    v, nr, t = _sphere()
    perp = np.cross(nr, np.array([0.0, 0.0, 1.0], np.float32)).astype(np.float32)
    cases = {"wobble": (_wobble(v, nr, 4), None),
             "past the pad": (v + np.float32(0.05) * nr,
                              "deformation parameter |s|=" if dirs
                              else "deformation 0.0500 exceeds"),
             "off-axis": (v + np.float32(0.01) * perp,
                          "off-axis deformation" if dirs else None)}
    d = nr if dirs else None
    for name, (vd, want) in cases.items():
        msgs = []
        for check, conv in ((rr.check_deform_contract, _t),
                            (jt.check_deform_contract, jnp.asarray)):
            try:
                check(conv(vd), conv(v), PAD, None if d is None else conv(d))
                msgs.append(None)
            except RuntimeError as e:
                msgs.append(str(e))
        assert msgs[0] == msgs[1], name
        assert (msgs[0] is None) == (want is None), name
        assert want is None or msgs[0].startswith(want), name
    rfit = rt.RaystabTiledRefitter(_t(v), _t(t), _t(nr), N, pad=0.02,
                                   pad_dirs=_t(nr) if dirs else None)
    with pytest.raises(RuntimeError, match="exceeds the refit pad"):
        rfit.refit(_t(v + np.float32(0.05) * nr), check=True)


# ---- the accel cache ----------------------------------------------------------

def test_accel_cache_round_trips(tmp_path):
    """Both gens: a miss builds and saves an entry under the port's own
    prefix, a hit loads the same compact (and the same accel); explicit
    save/load; "off" builds without writing; a stale or foreign file is
    rebuilt over, and JAX's entries are never read."""
    v, nr, t = _sphere()
    vt, tt, nt = _t(v), _t(t), _t(nr)
    jac.cached_compact7(jnp.asarray(v), jnp.asarray(t), n=N,
                        cache_dir=str(tmp_path / "jax"))
    for gen, cached, save, load, prefix in (
            ("gen-6", ac.cached_compact2, ac.save_compact2, ac.load_compact2, "pt6_"),
            ("gen-7", ac.cached_compact7, ac.save_compact7, ac.load_compact7, "pt7_")):
        d = tmp_path / gen
        c1 = cached(vt, tt, N, cache_dir=str(d), pad=PAD, pad_dirs=nt)
        files = os.listdir(d)
        assert len(files) == 1 and files[0].startswith(prefix)
        c2 = cached(vt, tt, N, cache_dir=str(d), pad=PAD, pad_dirs=nt)
        assert _compact_equal(c1, c2)
        assert not _compact_equal(c1, cached(vt, tt, N, cache_dir=str(d)))
        assert len(os.listdir(d)) == 2  # the static compact has its own key
        save(str(d / "x.npz"), c1)
        assert _compact_equal(c1, load(str(d / "x.npz")))
        (d / "junk.npz").write_bytes(b"not a zip")
        assert load(str(d / "junk.npz")) is None
        assert load(str(tmp_path / "jax" / os.listdir(tmp_path / "jax")[0])) is None
        off = tmp_path / "off"
        assert _compact_equal(c1, cached(vt, tt, N, cache_dir="off", pad=PAD,
                                         pad_dirs=nt))
        assert not off.exists()
    a7 = ac.cached_build_raystab_accel7(vt, tt, nt, N, cache_dir=str(tmp_path / "b"))
    b7 = ac.cached_build_raystab_accel7(vt, tt, nt, N, cache_dir=str(tmp_path / "b"))
    assert torch.equal(rt.raystab_query7(a7)[1], rt.raystab_query7(b7)[1])
    a6 = ac.cached_build_raystab_accel2(vt, tt, nt, N, cache_dir=str(tmp_path / "b"))
    assert torch.equal(rf.raystab_query2(a6)[1], rt.raystab_query7(a7)[1])
    assert len(os.listdir(tmp_path / "b")) == 2


def _compact_equal(a, b) -> bool:
    if isinstance(a, rt.RaystabCompact7):
        return (all(torch.equal(getattr(a, k), getattr(b, k))
                    for k in ("tids", "offs", "ids"))
                and ((a.bounds is None and b.bounds is None)
                     or torch.equal(a.bounds, b.bounds))
                and a.stats == b.stats)
    return (len(a.classes) == len(b.classes) and all(
        _same(x[0], y[0]) and _same(x[1], y[1])
        and ((x[2] is None and y[2] is None) or _same(x[2], y[2]))
        for x, y in zip(a.classes, b.classes))
        and (a.ov_ids is None) == (b.ov_ids is None)
        and (a.ov_ids is None or _same(a.ov_ids, b.ov_ids)) and a.stats == b.stats)


@pytest.mark.parametrize("n", [N, 128])
def test_noaccelcache_builds_fresh(tmp_path, monkeypatch, n):
    """-noaccelcache parses to accel_cache=False, and the GPU's static accel
    (gen-6 below 128^3, gen-7 above; built here on CPU tensors) is then
    built without touching the cache; with the cache on (the default) the
    build writes one entry and a second build loads it: the same tables."""
    monkeypatch.setenv("DXRVOX_ACCEL_CACHE", str(tmp_path))
    cfg = parse_args(["-noaccelcache", "-grid", str(n)])
    assert cfg.accel_cache is False and VoxelizerConfig().accel_cache is True
    v, nr, t = _sphere()
    mesh = MeshBuffers(positions=_t(v), normals=_t(nr), tris=_t(t),
                       positions_norm=_t(v))
    fresh = ppl._stab_accel_for(cfg, mesh)
    assert isinstance(fresh, rt.RaystabAccel7 if n >= 128 else rf.RaystabAccel2)
    assert os.listdir(tmp_path) == []
    cached = ppl._stab_accel_for(cfg.replace(accel_cache=True), mesh)
    assert [f[:4] for f in os.listdir(tmp_path)] == ["pt7_" if n >= 128 else "pt6_"]
    again = ppl._stab_accel_for(cfg.replace(accel_cache=True), mesh)
    for a in (cached, again):
        for f in ("rays", "cand_off", "cand_cnt"):
            assert torch.equal(getattr(a.main, f), getattr(fresh.main, f)), f
        assert torch.equal(rc.candidate_rows(a.main), rc.candidate_rows(fresh.main))


# ---- the CPU's deforming frame --------------------------------------------------

def test_cpu_deforming_raystab_frame_matches_jax(monkeypatch, jax_python_path):  # noqa: F811
    """The CPU's deforming -inside raystab frames rebuild gen-1 when the mesh
    object changes (no refit on the CPU, as in JAX): two wobbled frames of
    the port's FramePipeline(deforming=True) give JAX's own CPU frame's
    grids (run op by op), with ``render`` monkeypatched on both sides."""
    v, nr, t = (np.asarray(a) for a in box_mesh((-0.6, -0.5, -0.4), (0.5, 0.6, 0.45)))
    v, nr, t = v.astype(np.float32), nr.astype(np.float32), t.astype(np.int32)
    grids = {}

    def capture(key):
        def render(grid, consts, cfg, impl="warp", **kw):
            grids.setdefault(key, []).append(grid)
            return torch.zeros((4, 4, 3)) if key == "port" else jnp.zeros((4, 4, 3))
        return render

    monkeypatch.setattr(jpl, "render", capture("jax"))
    monkeypatch.setattr(ppl, "render", capture("port"))
    kw = dict(grid_size=N, width=8, height=8, inside_mode="raystab")
    jmesh = JaxMeshBuffers(positions=jnp.asarray(v), normals=jnp.asarray(nr),
                           tris=jnp.asarray(t), positions_norm=jnp.asarray(v))
    mesh = MeshBuffers(positions=_t(v), normals=_t(nr), tris=_t(t),
                       positions_norm=_t(v))
    jp = jpl.FramePipeline(JaxConfig(**kw), jmesh, deforming=True)
    pp = ppl.FramePipeline(VoxelizerConfig(**kw), mesh, deforming=True)
    accels = []
    for frame in (2, 6):
        vd = _wobble(v, nr, frame)
        jp.mesh = dataclasses.replace(jmesh, positions_norm=jnp.asarray(vd))
        with jax.disable_jit():
            jp.frame(None)
        pp.mesh = dataclasses.replace(mesh, positions_norm=_t(vd))
        pp.frame(None)
        accels.append(pp._stab_accel)
        assert isinstance(pp._stab_accel, rf.RaystabAccel) and pp._refitter is None
    assert accels[0] is not accels[1]  # rebuilt for the new mesh object
    for want, got in zip(grids["jax"], grids["port"]):
        assert _same(got.words.numpy(), want.words)
        assert _same(got.rgba.numpy(), want.rgba)
    assert not _same(grids["port"][0].words.numpy(), grids["port"][1].words.numpy())
