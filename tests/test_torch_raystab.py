"""The ray-stab inside rule of the CUDA build (gen-6 accel, n < 128) against
the JAX package on the CPU.

The same numpy meshes go through both packages: the intersection primitives,
both oracles, the compact accel build, the candidate rows, the fold +
extraction kernel's plain version (against the Pallas kernels in interpret
mode), the whole query and the frame (which on the CPU runs gen-1, as the
JAX package's CPU frame does; gen-1 itself: tests/test_torch_raystab1.py). The box has its faces on voxel centres
(ties on every boundary); the near-origin soup fills the shared stream past
one 256-candidate chunk; the dense cone gives a multi-chunk class with skip
bounds; gs=(4,) gives cells of several strips; (16, 8, 4) a three-level
ladder.

The JAX side runs op by op (``jax.disable_jit``), as the port runs: jitted,
XLA:CPU contracts multiply-adds into FMAs (the radial coefficients, the
radial_hit chains, the normal finalize), which moves last bits and, on the
box, boundary decisions. The Pallas interpret kernels are always compiled,
so they are compared bit for bit on tables whose arithmetic is exact
(products and sums of short-mantissa values, axis-aligned normals), where a
contraction cannot change a bit; on meshes the JAX interpret query equals
the jitted JAX oracle, the port equals the op-by-op one, and the two differ
by exactly the jitted-vs-op-by-op JAX difference (ROADMAP.md, section 3).
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dxrvoxelizer_tpu.ops.raystab_fast as jrf
from dxrvoxelizer_tpu.core.pipeline import render as jax_render
from dxrvoxelizer_tpu.core.pipeline import VoxelGrid as JaxVoxelGrid
from dxrvoxelizer_tpu.models.scene import Scene as JaxScene
from dxrvoxelizer_tpu.ops import intersect as ji
from dxrvoxelizer_tpu.ops import voxelize_ref as jvr
from dxrvoxelizer_tpu.ops.packing import pack_bits_z as jax_pack_bits_z
from dxrvoxelizer_tpu.ops.packing import quantize_r10g10b10a2 as jax_quantize
from dxrvoxelizer_tpu.ops.raystab_pallas import (
    stab_closest_hit2,
    stab_fold_extract2,
    stab_fold_extract3,
)
from dxrvoxelizer_tpu.utils import native
from dxrvoxelizer_tpu.utils.config import VoxelizerConfig as JaxConfig
from dxrvoxelizer_tpu.utils.objloader import ObjMesh as JaxObjMesh
from dxrvoxelizer_tpu_torch.core.pipeline import FramePipeline, voxelize
from dxrvoxelizer_tpu_torch.models.camera import OrbitCamera
from dxrvoxelizer_tpu_torch.ops import intersect as pi
from dxrvoxelizer_tpu_torch.ops import raystab_cuda as rc
from dxrvoxelizer_tpu_torch.ops import raystab_fast as rf
from dxrvoxelizer_tpu_torch.ops import voxelize_ref as vr
from dxrvoxelizer_tpu_torch.state import (
    MESH_FIELDS,
    mesh_buffers_from_numpy,
    raystab_compact_from_numpy,
)
from dxrvoxelizer_tpu_torch.utils.config import VoxelizerConfig
from tests.meshes import box_mesh, icosphere_mesh, tetrahedron_mesh

torch.set_num_threads(2)


def _box_on_centers(n):
    c = [(i + 0.5) / n * 2.0 - 1.0 for i in (3, 5, 2, n - 6, n - 4, n - 9)]
    return box_mesh(c[:3], c[3:])


def _near_origin():
    """300 triangles straddling the origin: all near-origin (shared stream
    of two 256-candidate chunks)."""
    rng = np.random.default_rng(11)
    nt = 300
    centers = rng.standard_normal((nt, 1, 3)).astype(np.float32) * 0.02
    offsets = rng.standard_normal((nt, 3, 3)).astype(np.float32) * 0.3
    tri_v = centers + offsets
    e1 = tri_v[:, 1] - tri_v[:, 0]
    e2 = tri_v[:, 2] - tri_v[:, 0]
    fn = np.cross(e1, e2)
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
    normals = np.repeat(fn, 3, axis=0).astype(np.float32)
    tris = np.arange(nt * 3, dtype=np.int32).reshape(nt, 3)
    return tri_v.reshape(-1, 3), normals, tris


# name -> (mesh, n, cubemap ladder or None for the default)
CASES = {
    "tet16": (tetrahedron_mesh, 16, None),
    "icosphere1_16": (lambda: icosphere_mesh(1), 16, None),
    "icosphere2_32": (lambda: icosphere_mesh(2), 32, None),
    "icosphere3_32": (lambda: icosphere_mesh(3), 32, None),
    "box_on_centers32": (lambda: _box_on_centers(32), 32, None),
    "near_origin32": (_near_origin, 32, None),
    "ladder3_32": (lambda: icosphere_mesh(2), 32, (16, 8, 4)),
    "multistrip32": (lambda: icosphere_mesh(2), 32, (4,)),
    "dense_cone16": (lambda: icosphere_mesh(3, radius=0.08,
                                            center=(0.5, 0.3, -0.4)), 16, None),
}


@functools.cache
def _mesh(name):
    v, nr, t = CASES[name][0]()
    return (np.asarray(v, np.float32), np.asarray(nr, np.float32),
            np.asarray(t, np.int32))


def _port(name):
    v, nr, t = _mesh(name)
    return (torch.from_numpy(v), torch.from_numpy(nr),
            torch.from_numpy(t.astype(np.int64)))


def _jax(name):
    return tuple(jnp.asarray(a) for a in _mesh(name))


@functools.cache
def _jax_radial_oracle(name, rule="backface"):
    """The JAX radial oracle, op by op -> numpy (occ, rgba)."""
    n = CASES[name][1]
    with jax.disable_jit():
        occ, rgba = jvr.voxelize_raystab_radial_ref(*_jax(name), n=n, rule=rule)
    return np.asarray(occ), np.asarray(rgba)


def _same(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


def _diff(a, b):
    return int((np.asarray(a) != np.asarray(b)).sum())


# ---- intersection primitives ------------------------------------------------

def _random_rays_tris(seed=7, rays=96, tris=40):
    rng = np.random.default_rng(seed)
    tv = rng.standard_normal((tris, 3, 3)).astype(np.float32)
    pos = rng.standard_normal((rays, 3)).astype(np.float32)
    length = np.sqrt((pos[:, 0] * pos[:, 0] + pos[:, 1] * pos[:, 1])
                     + pos[:, 2] * pos[:, 2]).astype(np.float32)
    dirs = (pos / length[:, None]).astype(np.float32)
    # a few triangles through existing vertices and degenerate ones
    tv[5] = tv[4][[1, 0, 2]]
    tv[6, 2] = tv[6, 1]
    return pos, dirs, length, tv.reshape(-1, 3), np.arange(tris * 3,
                                                           dtype=np.int32).reshape(tris, 3)


@pytest.mark.parametrize("fn", ["triangle_soup", "mt_hit", "radial_setup",
                                "radial_hit", "closest_hit",
                                "radial_closest_hit"])
def test_intersect_bit_identical_to_jax(fn):
    pos, dirs, length, verts, tris = _random_rays_tris()
    tp = {k: torch.from_numpy(a) for k, a in
          dict(pos=pos, dirs=dirs, length=length, verts=verts,
               tris=tris.astype(np.int64)).items()}
    tj = {k: jnp.asarray(a) for k, a in
          dict(pos=pos, dirs=dirs, length=length, verts=verts, tris=tris).items()}
    with jax.disable_jit():
        if fn == "triangle_soup":
            want = ji.triangle_soup(tj["verts"], tj["tris"])
            got = pi.triangle_soup(tp["verts"], tp["tris"])
        elif fn == "mt_hit":
            v0, e1, e2 = ji.triangle_soup(tj["verts"], tj["tris"])
            want = ji.mt_hit(tj["pos"][:, None], tj["dirs"][:, None],
                             v0[None], e1[None], e2[None])
            v0, e1, e2 = pi.triangle_soup(tp["verts"], tp["tris"])
            got = pi.mt_hit(tp["pos"][:, None], tp["dirs"][:, None],
                            v0[None], e1[None], e2[None])
        elif fn == "radial_setup":
            want = ji.radial_setup(tj["verts"], tj["tris"])
            got = pi.radial_setup(tp["verts"], tp["tris"])
        elif fn == "radial_hit":
            def args(m, d):
                g0, g1, g2, c = m.radial_setup(d["verts"], d["tris"])
                return (d["dirs"][:, None, 0], d["dirs"][:, None, 1],
                        d["dirs"][:, None, 2], d["length"][:, None],
                        *(g[None, :, k] for g in (g0, g1, g2) for k in range(3)),
                        c[None, :])
            want = ji.radial_hit(*args(ji, tj))
            got = pi.radial_hit(*args(pi, tp))
        elif fn == "closest_hit":
            v0, e1, e2 = ji.triangle_soup(tj["verts"], tj["tris"])
            want = ji.closest_hit(tj["pos"], tj["dirs"], v0, e1, e2, tri_chunk=16)
            v0, e1, e2 = pi.triangle_soup(tp["verts"], tp["tris"])
            got = pi.closest_hit(tp["pos"], tp["dirs"], v0, e1, e2, tri_chunk=16)
        else:
            want = ji.radial_closest_hit(tj["dirs"], tj["length"],
                                         *ji.radial_setup(tj["verts"], tj["tris"]),
                                         tri_chunk=16)
            got = pi.radial_closest_hit(tp["dirs"], tp["length"],
                                        *pi.radial_setup(tp["verts"], tp["tris"]),
                                        tri_chunk=16)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert _same(g.numpy(), w), fn
    if fn in ("mt_hit", "radial_hit"):
        assert bool(got[-1].any()) and not bool(got[-1].all())  # hits and misses


# ---- oracles ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tet16", "icosphere2_32", "box_on_centers32",
                                  "dense_cone16"])
@pytest.mark.parametrize("rule", ["backface", "hit"])
def test_mt_oracle_bit_identical_to_jax(name, rule):
    n = CASES[name][1]
    occ, rgba = vr.voxelize_raystab_ref(*_port(name), n=n, rule=rule)
    with jax.disable_jit():
        want = jvr.voxelize_raystab_ref(*_jax(name), n=n, rule=rule)
    assert _same(occ.numpy(), want[0]) and _same(rgba.numpy(), want[1])
    assert bool(occ.any())


@pytest.mark.parametrize("name", list(CASES))
def test_radial_oracle_bit_identical_to_jax(name):
    n = CASES[name][1]
    occ, rgba = vr.voxelize_raystab_radial_ref(*_port(name), n=n)
    want = _jax_radial_oracle(name)
    assert _same(occ.numpy(), want[0]) and _same(rgba.numpy(), want[1])
    assert bool(occ.any())


@pytest.mark.parametrize("impl,rule", [("mt", "backface"), ("radial", "hit")])
def test_radial_oracle_options_bit_identical_to_jax(impl, rule):
    name = "icosphere2_32"
    n = CASES[name][1]
    occ, rgba = vr.voxelize_raystab_radial_ref(*_port(name), n=n, rule=rule,
                                               normal_impl=impl)
    with jax.disable_jit():
        want = jvr.voxelize_raystab_radial_ref(*_jax(name), n=n, rule=rule,
                                               normal_impl=impl)
    assert _same(occ.numpy(), want[0]) and _same(rgba.numpy(), want[1])


# ---- the accel build ------------------------------------------------------------

def _jax_compact_python_path(monkeypatch, name):
    """JAX's compact build through its Python packer (no native code, no
    on-disk ray-table cache)."""
    monkeypatch.setenv("DXRVOX_RAYTAB_CACHE", "off")
    for fn in ("accel_pack_tables_native", "accel_pack_native",
               "raytab_native", "dir_cells_native"):
        monkeypatch.setattr(native, fn, lambda *a, **k: None)
    jrf._ray_table_filled.cache_clear()
    try:
        _, n, gs = CASES[name]
        v, _, t = _jax(name)
        return jrf.build_raystab_compact2(v, t, n, gs)
    finally:
        jrf._ray_table_filled.cache_clear()


@pytest.mark.parametrize("name", list(CASES))
def test_compact_build_matches_jax_python_path(monkeypatch, name):
    jc = _jax_compact_python_path(monkeypatch, name)
    v, _, t = _port(name)
    _, n, gs = CASES[name]
    pc = rf.build_raystab_compact2(v, t, n, gs)
    conv = raystab_compact_from_numpy(n, jc.classes, jc.ov_ids,
                                      jc.stats.levels, jc.stats.near_origin)
    assert len(pc.classes) == len(conv.classes)
    for (r1, t1, b1), (r2, t2, b2) in zip(pc.classes, conv.classes):
        assert _same(r1, r2) and _same(t1, t2)
        assert (b1 is None and b2 is None) or _same(b1, b2)
    assert (pc.ov_ids is None) == (conv.ov_ids is None)
    if pc.ov_ids is not None:
        assert _same(pc.ov_ids, conv.ov_ids)
    assert pc.stats == conv.stats
    # every ray in at most one strip
    rays = np.concatenate([c[0][c[0] >= 0] for c in pc.classes] or [[]])
    assert np.unique(rays).size == rays.size
    if name == "dense_cone16":
        assert any(c[2] is not None for c in pc.classes)  # multi-chunk class


@pytest.mark.parametrize("name", ["icosphere2_32", "near_origin32"])
def test_candidate_rows_match_jax_fused_matrix(name):
    """The assembled rows are gathers of the port's fused matrix, which is
    JAX's ``_fused_coef_matrix`` run op by op, bit for bit, and so is X.9's
    mirror (its kernel's order of roundings)."""
    v, nr, t = _port(name)
    n = CASES[name][1]
    jv, jn, jt = _jax(name)
    with jax.disable_jit():
        want = np.asarray(jrf._fused_coef_matrix(jv, jt, jn))
    assert _same(rf._fused_coef_matrix(v, t, nr).numpy(), want)
    assert _same(rf.fused_rows_mirror(v.numpy(), t.numpy(), nr.numpy()), want)
    compact = rf.build_raystab_compact2(v, t, n)
    accel = rf.assemble_raystab_accel2(compact, v, t, nr)
    if accel.main is not None:
        ids = np.concatenate([tab[tab >= 0] for _, tab, _ in compact.classes])
        assert _same(accel.main.rows.numpy(), want[ids])
    if accel.ov is not None:
        assert _same(accel.ov.rows.numpy(), want[compact.ov_ids])


# ---- the kernel's plain version against the Pallas kernels --------------------

T_COUNT = 5000


def _exact_tables(seed, c, k, shared=False, bounds=False, shared_cnt=None):
    """JAX-layout tables whose arithmetic is exact in f32 (so an FMA cannot
    change a bit): directions and coefficients on a 1/8 grid, s0 and c on a
    1/16 grid, axis-aligned vertex normals; padding lanes, padding
    candidates, exact t ties between rows and den == 0 rows included."""
    rng = np.random.default_rng(seed)
    d = rng.integers(-8, 9, (c, 3, 128)) / 8.0
    s0 = rng.integers(0, 9, (c, 1, 128)) / 16.0
    d[:, 0][(d == 0).all(axis=1)] = 0.125  # a real lane is never all zero
    pad = rng.random((c, 128)) < 0.1
    d = np.where(pad[:, None], 0.0, d)
    s0 = np.where(pad[:, None], 0.0, s0)
    rays = np.concatenate([d, s0, np.zeros((c, 4, 128))], 1).astype(np.float32)
    cs = 1 if shared else c
    g = rng.integers(-8, 9, (cs, k, 9)) / 8.0
    deg = rng.random((cs, k)) < 0.05  # g0 + g1 + g2 = 0: den == 0 always
    g[..., 6:9] = np.where(deg[..., None], -(g[..., 0:3] + g[..., 3:6]), g[..., 6:9])
    cc = rng.integers(-32, 33, (cs, k, 1)) / 16.0
    dup = rng.random((cs, k)) < 0.1  # exact t ties, broken by the lower id
    src = rng.integers(0, k, (cs, k))
    g = np.where(dup[..., None], np.take_along_axis(g, src[..., None], 1), g)
    cc = np.where(dup[..., None], np.take_along_axis(cc, src[..., None], 1), cc)
    ids = np.stack([rng.permutation(T_COUNT)[:k] for _ in range(cs)])
    coefs = np.concatenate([g, cc, ids[..., None], np.zeros((cs, k, 1))], -1)
    ax = rng.integers(0, 3, (cs, k))
    sign = rng.choice([-1.0, 1.0], (cs, k))
    nrm = np.zeros((cs, k, 3))
    np.put_along_axis(nrm, ax[..., None], sign[..., None], -1)
    ntab = np.concatenate([nrm, nrm, nrm, np.zeros((cs, k, 3))], -1)
    lo = k // 2 if k > 256 else 1
    cnt = rng.integers(lo, k + 1, cs)
    cnt[0] = k if shared_cnt is None else shared_cnt
    live = np.arange(k)[None, :] < cnt[:, None]
    coefs = np.where(live[..., None], coefs, 0.0)
    coefs[..., 10] = np.where(live, coefs[..., 10], 2.0**30)
    ntab = np.where(live[..., None], ntab, 0.0)
    if shared:
        coefs, ntab, cnt = coefs[0], ntab[0], np.full(c, cnt[0])
    bnd = None
    if bounds:
        bnd = (rng.integers(0, 24, (c, k // 256)) / 16.0).astype(np.float32)
    return (rays, coefs.astype(np.float32), ntab.astype(np.float32), cnt, bnd)


def _port_tables(rays, coefs, ntab, cnt, bnd) -> rc.StripTables:
    c = rays.shape[0]
    if coefs.ndim == 2:  # shared rows
        rows = np.concatenate([coefs[:cnt[0]], ntab[:cnt[0]]], -1)
        off = np.zeros(c, np.int64)
    else:
        rows = np.concatenate([np.concatenate([coefs[s, :cnt[s]], ntab[s, :cnt[s]]], -1)
                               for s in range(c)])
        off = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    b = None
    if bnd is not None:
        b = torch.from_numpy(bnd)
    return rc.StripTables(
        rays=torch.from_numpy(np.ascontiguousarray(rays[:, :4])),
        cand_off=torch.from_numpy(off.astype(np.int32)),
        cand_cnt=torch.from_numpy(np.asarray(cnt, np.int32)),
        rows=torch.from_numpy(np.ascontiguousarray(rows, np.float32)),
        bounds=b,
    )


@pytest.mark.parametrize("layout,rule", [
    ("classic48", "backface"), ("classic48", "hit"),
    ("lanes512_bounds", "backface"), ("shared48", "hit"),
])
def test_fold_extract_plain_bit_identical_to_pallas(layout, rule):
    """fold_extract_plain against stab_fold_extract2 (classic [C,K,12]
    tables) and stab_fold_extract3 (lane-aligned [C,12,K], with chunk-skip
    bounds) in interpret mode, and the shared near-origin variant."""
    shared = layout == "shared48"
    k = 512 if layout == "lanes512_bounds" else 48
    rays, coefs, ntab, cnt, bnd = _exact_tables(
        3, 16, k, shared=shared, bounds=layout == "lanes512_bounds",
        shared_cnt=40 if shared else None)
    args = dict(k=k, t_count=T_COUNT, threshold=0.12, shared=shared,
                interpret=True, rule=rule)
    if layout == "lanes512_bounds":
        want = stab_fold_extract3(jnp.asarray(rays),
                                  jnp.asarray(coefs.transpose(0, 2, 1)),
                                  jnp.asarray(ntab.transpose(0, 2, 1)),
                                  bounds=jnp.asarray(bnd), **args)
    else:
        want = stab_fold_extract2(jnp.asarray(rays), jnp.asarray(coefs),
                                  jnp.asarray(ntab), **args)
    t, i, ns = rc.fold_extract_plain(_port_tables(rays, coefs, ntab, cnt, bnd),
                                     T_COUNT, 0.12, rule)
    assert _same(t.numpy(), want[0]) and _same(i.numpy(), want[1])
    assert _same(ns.numpy(), np.asarray(want[2]).transpose(0, 2, 1))
    hit = np.isfinite(t.numpy()) & (i.numpy() < T_COUNT)
    assert 0.2 < hit.mean() < 0.95  # hits, misses and padding lanes
    assert 0 < (ns.numpy()[..., 3] == 1.0).sum() <= hit.sum()


def test_fold_plain_bit_identical_to_stab_closest_hit2():
    """The fold-only instance's plain version against stab_closest_hit2 (the
    fold alone), on a multi-chunk class with skip bounds."""
    rays, coefs, ntab, cnt, bnd = _exact_tables(5, 16, 512, bounds=True)
    want = stab_closest_hit2(jnp.asarray(rays), jnp.asarray(coefs), 512,
                             interpret=True, bounds=jnp.asarray(bnd))
    tb = _port_tables(rays, coefs, ntab, cnt, bnd)
    t, i = rc.fold_plain(tb)
    assert _same(t.numpy(), want[0]) and _same(i.numpy(), want[1])
    # the fold is the fold+extract kernel's first half
    t2, i2, _ = rc.fold_extract_plain(tb, T_COUNT, 0.12)
    assert torch.equal(t, t2) and torch.equal(i, i2)
    # the bounds do skip chunks: without them some winners differ
    t3, _ = rc.fold_plain(rc.StripTables(tb.rays, tb.cand_off, tb.cand_cnt,
                                         tb.rows))
    assert not torch.equal(t, t3)


def test_kernel_wrappers_take_the_plain_version_on_cpu():
    rays, coefs, ntab, cnt, bnd = _exact_tables(9, 8, 48)
    tb = _port_tables(rays, coefs, ntab, cnt, bnd)
    before = (rc.FOLD_EXTRACT.launches, rc.FOLD.launches)
    for a, b in zip(rc.fold_extract(tb, T_COUNT, 0.12),
                    rc.fold_extract_plain(tb, T_COUNT, 0.12)):
        assert torch.equal(a, b)
    for a, b in zip(rc.fold(tb), rc.fold_plain(tb)):
        assert torch.equal(a, b)
    assert (rc.FOLD_EXTRACT.launches, rc.FOLD.launches) == before
    with pytest.raises(ValueError):
        rc.fold_extract(tb, T_COUNT, 0.12, rule="front")
    with pytest.raises(ValueError):
        rc.fold_extract(tb, 2**24, 0.12)


# ---- the query ------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_query_bit_identical_to_radial_oracle(name):
    """raystab_query2 (the kernel's plain version on the CPU) against the
    JAX radial oracle run op by op: occupancy and the unquantized rgba."""
    v, nr, t = _port(name)
    _, n, gs = CASES[name]
    accel = rf.build_raystab_accel2(v, t, nr, n=n, gs=gs)
    occ, rgba = rf.raystab_query2(accel)
    want = _jax_radial_oracle(name)
    assert _same(occ.numpy(), want[0]) and _same(rgba.numpy(), want[1])
    if name == "multistrip32":
        assert (rf._ray_table_filled(n, 4)[1] > 128).any()
    if name in ("near_origin32", "box_on_centers32", "tet16"):
        assert accel.ov is not None
    else:
        assert accel.main is not None and accel.ov is None


def test_query_rule_hit_bit_identical_to_radial_oracle():
    v, nr, t = _port("icosphere2_32")
    accel = rf.build_raystab_accel2(v, t, nr, n=32)
    occ, rgba = rf.raystab_query2(accel, rule="hit")
    want = _jax_radial_oracle("icosphere2_32", "hit")
    assert _same(occ.numpy(), want[0]) and _same(rgba.numpy(), want[1])


# (occupancy voxels, rgba values) where the jitted JAX radial oracle (and
# so JAX's interpret query) differs from the op-by-op one on XLA:CPU
JIT_VS_OP_BY_OP = {"tet16": (0, 160), "icosphere1_16": (0, 1278),
                   "box_on_centers32": (387, 1246)}


@pytest.mark.parametrize("name", list(JIT_VS_OP_BY_OP))
def test_query_against_jax_interpret_query(monkeypatch, name):
    """On JAX's own accel (carried across as its compact product) the JAX
    interpret query equals the jitted JAX radial oracle bit for bit, the
    port's query equals the op-by-op one, and the two differ exactly where
    the jitted and the op-by-op JAX oracles differ: XLA:CPU's FMA
    contraction, not a fault of the port (ROADMAP.md, section 3)."""
    jc = _jax_compact_python_path(monkeypatch, name)
    n = CASES[name][1]
    jv, jn, jt = _jax(name)
    jaccel = jrf.assemble_raystab_accel2(jc, jv, jt, jn)
    j_occ, j_rgba = (np.asarray(a) for a in
                     jrf.raystab_query2(jv, jn, jt, jaccel, interpret=True))
    jit_occ, jit_rgba = (np.asarray(a) for a in
                         jvr.voxelize_raystab_radial_ref(jv, jn, jt, n=n))
    assert _same(j_occ, jit_occ) and _same(j_rgba, jit_rgba)
    v, nr, t = _port(name)
    accel = rf.assemble_raystab_accel2(
        raystab_compact_from_numpy(n, jc.classes, jc.ov_ids), v, t, nr)
    occ, rgba = rf.raystab_query2(accel)
    eager = _jax_radial_oracle(name)
    assert _same(occ.numpy(), eager[0]) and _same(rgba.numpy(), eager[1])
    assert _diff(occ.numpy(), j_occ) == _diff(eager[0], jit_occ)
    assert _diff(rgba.numpy(), j_rgba) == _diff(eager[1], jit_rgba)
    assert (_diff(eager[0], jit_occ), _diff(eager[1], jit_rgba)) == \
        JIT_VS_OP_BY_OP[name]


def test_sqrt_rn_is_the_correctly_rounded_root():
    """PyTorch's vectorized CPU sqrt may differ from IEEE in the last bit;
    the port's voxel-ray norms go through sqrt_rn, which equals numpy's
    correctly rounded float32 root."""
    from dxrvoxelizer_tpu_torch.ops.packing import voxel_centers_norm

    cx, cy, cz = voxel_centers_norm(64)
    pos = np.stack(np.meshgrid(cx, cy, cz, indexing="ij"), -1).reshape(-1, 3)
    ss = (pos[:, 0] * pos[:, 0] + pos[:, 1] * pos[:, 1]) + pos[:, 2] * pos[:, 2]
    assert _same(pi.sqrt_rn(torch.from_numpy(ss)).numpy(), np.sqrt(ss))
    assert _same(rf._ray_params(64)[1].numpy(), np.sqrt(ss))


def test_empty_and_degenerate_meshes():
    v = torch.zeros((3, 3))
    nr = torch.zeros((3, 3))
    for t in (torch.zeros((0, 3), dtype=torch.int64),
              torch.tensor([[0, 1, 2]])):
        occ, rgba = rf.voxelize_raystab_fast(v, nr, t, n=16)
        assert not bool(occ.any()) and not bool(rgba.any())


# ---- the pipeline ---------------------------------------------------------------

W, H, N = 96, 64, 32


def _tet_obj(cls):
    v, nrm, t = tetrahedron_mesh()
    return cls(positions=v, normals=nrm, indices=t.reshape(-1),
               aabb_min=v.min(axis=0), aabb_max=v.max(axis=0))


@pytest.mark.parametrize("mode", ["raystab", "normals"])
def test_frame_matches_jax_frame(monkeypatch, mode):
    """FramePipeline.frame with -inside raystab / -normals on the JAX mesh
    buffers within 2e-3 (the tet-golden bound) of the JAX renderer's frame
    of the grid JAX's own CPU frame voxelizes, run op by op: the gen-1
    accel's XLA query (-inside raystab), or the Moller-Trumbore oracle under
    rule "hit" on the parity oracle's words (-normals)."""
    monkeypatch.setenv("DXRVOX_RAYTAB_CACHE", "off")
    jscene = JaxScene(_tet_obj(JaxObjMesh))
    jb = jscene.buffers
    cam = OrbitCamera(W, H)
    fc = jscene.update_frame(cam.eye, cam.view_proj, W, H)
    jcfg = JaxConfig(grid_size=N, width=W, height=H)
    if mode == "raystab":
        jaccel = jrf.build_raystab_accel(jb.positions_norm, jb.tris, N)
        with jax.disable_jit():
            occ, rgba = jrf.raystab_query(jb.positions_norm, jb.normals, jb.tris,
                                          jaccel, impl="xla")
        words = jax_pack_bits_z(occ)
    else:
        with jax.disable_jit():
            words = jax_pack_bits_z(jvr.voxelize_parity_ref(
                jb.positions_norm, jb.tris, n=N))
            _, rgba = jvr.voxelize_raystab_ref(jb.positions_norm, jb.normals,
                                               jb.tris, n=N, rule="hit")
        from dxrvoxelizer_tpu.ops.packing import unpack_bits_z

        occ_f = unpack_bits_z(words, N).astype(jnp.float32)[..., None]
        rgba = jnp.concatenate([rgba[..., :3] * occ_f, occ_f], axis=-1)
    want = np.asarray(jax_render(JaxVoxelGrid(words=words, rgba=jax_quantize(rgba)),
                                 fc, jcfg))
    mesh = mesh_buffers_from_numpy({f: np.asarray(getattr(jb, f))
                                    for f in MESH_FIELDS}, "cpu")
    cfg = VoxelizerConfig(grid_size=N, width=W, height=H,
                          inside_mode="raystab" if mode == "raystab" else "parity",
                          parity_normals=mode == "normals")
    pipe = FramePipeline(cfg, mesh)
    got = pipe.frame(fc)
    assert got.shape == (H, W, 3) and bool(torch.isfinite(got).all())
    assert np.abs(got.numpy() - want).max() < 2e-3
    accel = pipe._stab_accel
    assert torch.equal(pipe.frame(fc), got) and pipe._stab_accel is accel  # built once
    # the CPU routes as JAX's: the gen-1 accel, or the oracle and no accel
    assert (isinstance(accel, rf.RaystabAccel) if mode == "raystab"
            else accel is None)


def test_voxelize_raystab_impls_and_grid():
    v, nr, t = _port("icosphere2_32")
    from dxrvoxelizer_tpu_torch.models.mesh import MeshBuffers

    mesh = MeshBuffers(positions=v, normals=nr, tris=t, positions_norm=v)
    auto = voxelize(mesh, 32, mode="raystab", quantize=False)
    radial = voxelize(mesh, 32, mode="raystab", impl="xla-radial", quantize=False)
    mt = voxelize(mesh, 32, mode="raystab", impl="xla", quantize=False)
    # on the CPU "auto" is the gen-1 accel: the Moller-Trumbore rule
    assert torch.equal(auto.words, mt.words) and torch.equal(auto.rgba, mt.rgba)
    assert torch.equal(auto.words, radial.words)  # no near-ties on the icosphere
    # the radial normals differ in the last bits: 5,803 of 6,191 voxels
    assert int(auto.occupancy().sum()) == 6191
    assert int((auto.rgba != radial.rgba).any(-1).sum()) == 5803
    # a gen-6 accel passed in still runs the radial query
    accel2 = rf.build_raystab_accel2(v, t, nr, n=32)
    g6 = voxelize(mesh, 32, mode="raystab", quantize=False, accel=accel2)
    assert torch.equal(g6.words, radial.words) and torch.equal(g6.rgba, radial.rgba)
    assert torch.equal(auto.density(), auto.rgba[..., 3])
    assert torch.equal(auto.occupancy(), auto.rgba[..., 3] != 0)
    q = voxelize(mesh, 32, mode="raystab")
    want = jax_quantize(jnp.asarray(auto.rgba.numpy()))
    assert _same(q.rgba.numpy(), want)
    parity = voxelize(mesh, 32, with_normals=True)
    assert torch.equal(parity.rgba[..., 3], parity.occupancy().to(torch.float32))
    # the JAX package's accel names: the same grid as "auto"
    for impl in ("queue", "pallas", "fast"):
        g = voxelize(mesh, 32, mode="raystab", impl=impl, quantize=False)
        assert torch.equal(g.words, auto.words) and torch.equal(g.rgba, auto.rgba)
    with pytest.raises(ValueError):
        voxelize(mesh, 32, mode="raystab", impl="pallas_bruteforce")


@pytest.mark.parametrize("vox_impl", ["queue", "pallas"])
def test_parity_impl_names_select_the_raystab_accel(vox_impl):
    """-voximpl queue / pallas name parity kernels: under -inside raystab
    they select the direction-space accel, as in the JAX package, and the
    frame equals the "auto" pipeline's."""
    from dxrvoxelizer_tpu_torch.utils.objloader import ObjMesh
    from dxrvoxelizer_tpu_torch.models.scene import Scene

    scene = Scene(_tet_obj(ObjMesh), "cpu")
    cam = OrbitCamera(W, H)
    fc = scene.update_frame(cam.eye, cam.view_proj, W, H)
    cfg = VoxelizerConfig(grid_size=N, width=W, height=H, inside_mode="raystab")
    pipe = FramePipeline(cfg, scene.buffers, vox_impl=vox_impl)
    got = pipe.frame(fc)
    assert pipe._stab_accel is not None
    assert torch.equal(got, FramePipeline(cfg, scene.buffers).frame(fc))
    parity = FramePipeline(cfg.replace(inside_mode="parity"), scene.buffers,
                           vox_impl=vox_impl)
    assert parity._stab_accel is None and torch.equal(
        parity.frame(fc), FramePipeline(cfg.replace(inside_mode="parity"),
                                        scene.buffers).frame(fc))


def _write_obj(path, verts, tris):
    lines = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in verts]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in tris]
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("flags", [["-inside", "raystab"], ["-normals"]])
def test_app_runs_raystab_and_normals_on_cpu(tmp_path, flags):
    v, _, t = icosphere_mesh(1)
    _write_obj(tmp_path / "ico.obj", v, t)
    res = subprocess.run(
        [sys.executable, "-m", "dxrvoxelizer_tpu_torch.app", "-mesh", "ico.obj",
         "-warp", "-grid", "32", "-frames", "2", "-width", "48", "-height",
         "32", "-out", "m.png", *flags],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={**os.environ,
             "PYTHONPATH": str(Path(__file__).resolve().parents[1])},
    )
    assert res.returncode == 0, res.stderr
    assert "wrote m.png" in res.stdout
    mode = "raystab" if "-inside" in flags else "parity"
    assert f"mode={mode}" in res.stdout


def test_stress_tables_exercise_the_fold_boundaries():
    """The synthetic strips the card tests hold kernels 2.5-2.7 to
    (tests/torch_cases.py), through the plain fold on the CPU: at equal t
    the lowest id wins across chunk and sub-chunk boundaries; the many-chunk
    strip skips some chunks and runs others, and its skips change nothing;
    padding strips stay -inf / 2^30 / zeros."""
    import dataclasses

    from dxrvoxelizer_tpu_torch.ops import raystab_cuda as rsc
    from tests.torch_cases import chunks_run, stab_stress

    case = stab_stress("cpu")
    tb = case.tables
    for rule in ("backface", "hit"):
        t_, i_, ns = rsc.fold_extract(tb, case.t_count, 0.12, rule)
        ties = case.strips["ties"]
        low = case.lowest[ties]
        assert bool((low >= 0).any())
        assert torch.equal(torch.where(low >= 0, i_[ties], -1), low)
        assert all(torch.equal(t_[s], t_[ties[0]]) for s in ties)
        pads = case.strips["padding"]
        assert bool((t_[pads] == float("-inf")).all())
        assert bool((i_[pads] == 2**30).all()) and not bool(ns[pads].any())
    many = case.strips["many_chunks"][0]
    runs = chunks_run(tb, many)
    assert case.many_chunks > 8 and len(runs) == case.many_chunks
    assert runs[0] and all(runs[j] for j in (3, 7))
    assert not all(runs) and sum(runs) >= 3
    unbounded = dataclasses.replace(tb, bounds=None)
    for a, b in zip(rsc.fold_plain(tb), rsc.fold_plain(unbounded)):
        assert torch.equal(a, b)
    assert bool(torch.isfinite(rsc.fold_plain(tb)[0][many]).any())


# ---- the row-id form: a stream that reads a table through its ids --------------

@pytest.mark.parametrize("name", ["near_origin32", "dense_cone16", "multistrip32"])
@pytest.mark.parametrize("rule", ["backface", "hit"])
def test_row_id_streams_fold_as_their_rows(name, rule):
    """The gen-6 accel assembled by id (the refitter's form) holds the fused
    matrix and int32 ids in each stream (main, and the near-origin one of
    ``near_origin32``), stands for the static assembly's rows bit for bit,
    and folds as they do; its query equals the static accel's and JAX's
    radial oracle run op by op."""
    v, nr, t = _port(name)
    from tests.torch_cases import assert_folds_equal

    _, n, gs = CASES[name]
    compact = rf.build_raystab_compact2(v, t, n, gs)
    rows = rf.assemble_raystab_accel2(compact, v, t, nr)
    by_id = rf.assemble_raystab_accel2(compact, v, t, nr, by_id=True)
    fused = rf._fused_coef_matrix(v, t, nr)
    streams = rf.strip_streams2(by_id)
    assert streams.keys() == rf.strip_streams2(rows).keys()
    assert name != "near_origin32" or set(streams) == {"main", "ov"}
    for f, tb in streams.items():
        want = getattr(rows, f)
        assert want.row_ids is None and tb.row_ids.dtype == torch.int32
        assert torch.equal(tb.rows, fused) and tb.rows is by_id.main.rows
        assert torch.equal(rc.candidate_rows(tb), want.rows)
        assert_folds_equal(tb, want, int(t.shape[0]), rule)
    got, static = rf.raystab_query2(by_id, rule=rule), rf.raystab_query2(rows, rule=rule)
    assert torch.equal(got[0], static[0]) and torch.equal(got[1], static[1])
    if rule == "backface":
        want = _jax_radial_oracle(name)
        assert _same(got[0].numpy(), want[0]) and _same(got[1].numpy(), want[1])


@pytest.mark.parametrize("rule", ["backface", "hit"])
def test_row_id_stress_tables_fold_as_their_rows(rule):
    """The fold's stress strips (ties across chunk and sub-chunk boundaries,
    skipped chunks, padding) in the row-id form of tests/torch_cases.py (a
    deduplicated table in another order): the plain kernels equal the
    materialised stream's bit for bit."""
    from tests.torch_cases import assert_folds_equal, by_id, stab_stress

    case = stab_stress("cpu")
    tb = by_id(case.tables)
    assert tb.rows.shape[0] < case.tables.rows.shape[0]  # rows are shared
    assert not torch.equal(tb.row_ids, torch.arange(tb.row_ids.shape[0],
                                                    dtype=torch.int32))
    assert torch.equal(rc.candidate_rows(tb), case.tables.rows)
    assert_folds_equal(tb, case.tables, case.t_count, rule)
