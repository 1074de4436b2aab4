"""The gen-7 ray-stab accel of the CUDA build (output-major voxel tiles, n >=
128 on a GPU) against the JAX package on the CPU.

The same numpy meshes go through both packages: the tile union and the
compact (per tile, bit for bit, against JAX's numpy pass and its native
one), the query (the fold + extraction kernel's plain version on the CPU)
against the port's radial oracle and its gen-6 query, and the query on
JAX's own compact against JAX's interpret-mode query, whose results differ
from the port's exactly where XLA:CPU's FMA contraction moves the jitted
oracle (tests/test_torch_raystab.py). Everything bit for bit.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dxrvoxelizer_tpu.ops.raystab_tiled as jt
from dxrvoxelizer_tpu.ops import voxelize_ref as jvr
from dxrvoxelizer_tpu.utils import native
from dxrvoxelizer_tpu_torch.ops import raystab_fast as rf
from dxrvoxelizer_tpu_torch.ops import raystab_tiled as rt
from dxrvoxelizer_tpu_torch.ops import voxelize_ref as vr
from dxrvoxelizer_tpu_torch.state import raystab_compact7_from_numpy
from tests.meshes import box_mesh, icosphere_mesh, tetrahedron_mesh
from tests.test_torch_raystab import (
    CASES,
    JIT_VS_OP_BY_OP,
    _diff,
    _jax_radial_oracle,
    _near_origin,
    _same,
)
from tests.test_torch_raystab import _jax as _jax_case
from tests.test_torch_raystab import _port as _port_case

torch.set_num_threads(2)

# name -> (mesh, n): JAX's own gen-7 cases (tests/test_raystab_tiled.py),
# the near-origin soup (every tile's list past one 256-candidate chunk: skip
# bounds) and a small sphere whose far tiles the near drop empties
MESHES = {
    "icosphere": (lambda: icosphere_mesh(2), 32),
    "box_near_origin": (lambda: box_mesh((-0.55, -0.45, -0.5), (0.5, 0.6, 0.45)), 32),
    "tetrahedron": (tetrahedron_mesh, 32),
    "near_origin": (_near_origin, 32),
    "small_sphere": (lambda: icosphere_mesh(2, radius=0.25), 32),
    "tet16": (tetrahedron_mesh, 16),
}


@functools.cache
def _mesh(name):
    v, nr, t = MESHES[name][0]()
    return (np.asarray(v, np.float32), np.asarray(nr, np.float32),
            np.asarray(t, np.int32))


def _port(name):
    v, nr, t = _mesh(name)
    return (torch.from_numpy(v), torch.from_numpy(nr),
            torch.from_numpy(t.astype(np.int64)))


def _jax_compact(monkeypatch, name, impl):
    """JAX's gen-7 compact, its tile union by its numpy pass or by
    ``accelpack.cpp``."""
    if impl == "numpy":
        monkeypatch.setattr(native, "tile_union_native", lambda *a, **k: None)
    elif native.get_pack_lib() is None:
        pytest.skip("JAX's native tile union did not build (no C++ toolchain)")
    v, _, t = _mesh(name)
    return jt.build_raystab_compact7(jnp.asarray(v), jnp.asarray(t),
                                     n=MESHES[name][1])


def _per_tile(c: rt.RaystabCompact7) -> dict:
    """tile id -> (candidate ids, chunk bounds or None)."""
    offs = c.offs.tolist()
    out = {}
    for i, tile in enumerate(c.tids.tolist()):
        b = None
        if c.bounds is not None and offs[i + 1] - offs[i] > rt.K_BLOCK:
            b = c.bounds[i].numpy()
        out[tile] = (c.ids[offs[i]:offs[i + 1]].numpy(), b)
    return out


@pytest.mark.parametrize("impl", ["numpy", "native"])
@pytest.mark.parametrize("name", list(MESHES))
def test_tile_union_and_compact_match_jax(monkeypatch, name, impl):
    """Per tile, the port's candidate ids (after the near drop, in (bound,
    id) order) and chunk bounds equal JAX's; so do the live tiles and the
    stats, and the compact carried across from JAX's classes."""
    jc = _jax_compact(monkeypatch, name, impl)
    v, _, t = _port(name)
    n = MESHES[name][1]
    pc = rt.build_raystab_compact7(v, t, n=n)
    conv = raystab_compact7_from_numpy(n, jc.classes, g_fine=jc.stats.g_fine,
                                       near_origin=jc.stats.near_origin)
    got, want = _per_tile(pc), _per_tile(conv)
    assert sorted(got) == sorted(want) == pc.tids.tolist()
    for tile, (ids, b) in want.items():
        assert _same(got[tile][0], ids), tile
        assert (b is None) == (got[tile][1] is None), tile
        if b is not None:
            assert _same(got[tile][1], b), tile
    assert pc.stats == conv.stats
    assert pc.stats.live_tiles == jc.stats.live_tiles
    assert pc.stats.near_origin == jc.stats.near_origin
    if name == "near_origin":
        assert pc.bounds is not None and pc.stats.near_origin > 256
    if name == "small_sphere":
        assert pc.stats.dead_tiles > pc.stats.live_tiles


@pytest.mark.parametrize("name", ["icosphere", "box_near_origin", "tetrahedron",
                                  "near_origin", "small_sphere"])
def test_query_bit_identical_to_radial_oracle_and_gen6(name):
    """raystab_query7 (the fold's plain version on the CPU) against the
    port's radial oracle (JAX's op by op, bit for bit) and the gen-6 query:
    occupancy and the unquantized rgba, both rules; dead tiles are zeros."""
    v, nr, t = _port(name)
    n = MESHES[name][1]
    accel = rt.build_raystab_accel7(v, t, nr, n=n)
    accel6 = rf.build_raystab_accel2(v, t, nr, n=n)
    assert accel.main.strips == accel.stats.live_tiles
    for rule in ("backface", "hit"):
        occ, rgba = rt.raystab_query7(accel, rule=rule)
        want = vr.voxelize_raystab_radial_ref(v, nr, t, n=n, rule=rule)
        assert _same(occ.numpy(), want[0].numpy())
        assert _same(rgba.numpy(), want[1].numpy())
        q6 = rf.raystab_query2(accel6, rule=rule)
        assert torch.equal(occ, q6[0]) and torch.equal(rgba, q6[1])
        assert bool(occ.any())
    # the stateless call routes through the accel's query, as voxelize does
    q = rf.raystab_query(v, nr, t, accel)
    assert torch.equal(q[1], rt.raystab_query7(accel)[1])


@pytest.mark.parametrize("name", ["tet16", "box_on_centers32"])
def test_query_against_jax_interpret_query(name):
    """On JAX's own gen-7 compact, carried across with
    ``raystab_compact7_from_numpy``: JAX's interpret-mode query equals its
    jitted radial oracle, the port's query equals the op-by-op one, and the
    two differ exactly where the two JAX oracles do (XLA:CPU's FMA
    contraction; tests/test_torch_raystab.py)."""
    n = CASES[name][1]
    jv, jn, jtri = _jax_case(name)
    jc = jt.build_raystab_compact7(jv, jtri, n=n)
    jaccel = jt.assemble_raystab_accel7(jc, jv, jtri, jn)
    j_occ, j_rgba = (np.asarray(a) for a in
                     jt.raystab_query7(jv, jn, jtri, jaccel, interpret=True))
    jit_occ, jit_rgba = (np.asarray(a) for a in
                         jvr.voxelize_raystab_radial_ref(jv, jn, jtri, n=n))
    assert _same(j_occ, jit_occ) and _same(j_rgba, jit_rgba)
    v, nr, t = _port_case(name)
    accel = rt.assemble_raystab_accel7(
        raystab_compact7_from_numpy(n, jc.classes), v, t, nr)
    occ, rgba = rt.raystab_query7(accel)
    eager = _jax_radial_oracle(name)
    assert _same(occ.numpy(), eager[0]) and _same(rgba.numpy(), eager[1])
    assert _diff(occ.numpy(), j_occ) == _diff(eager[0], jit_occ)
    assert _diff(rgba.numpy(), j_rgba) == _diff(eager[1], jit_rgba)
    assert (_diff(eager[0], jit_occ), _diff(eager[1], jit_rgba)) == \
        JIT_VS_OP_BY_OP[name]


def test_tile_layout_matches_jax():
    """A tile's lanes are its voxels in x-major raster order, as JAX's
    ``_tile_vox_ids``; every voxel in exactly one tile, and the query's
    untiling (reshape + permute) puts lane l of tile b at that voxel."""
    n = 32
    nt = n ** 3 // 128
    vox = rt._tile_vox_ids(torch.arange(nt), n)
    want = np.asarray(jt._tile_vox_ids(jnp.arange(nt, dtype=jnp.int32), n,
                                       jt.TILE))
    assert _same(vox.numpy(), want)
    assert _same(np.sort(vox.reshape(-1).numpy()), np.arange(n ** 3))
    assert _same(rt._tile_ids(n)[vox.reshape(-1).numpy()],
                 np.repeat(np.arange(nt), 128))
    tx, ty, tz = rt.TILE
    lanes = torch.arange(nt * 128, dtype=torch.float32).reshape(nt, 128)
    grid = (lanes.reshape(n // tx, n // ty, n // tz, tx, ty, tz)
            .permute(0, 3, 1, 4, 2, 5).reshape(-1))
    assert _same(grid[vox.reshape(-1)].numpy(), lanes.reshape(-1).numpy())


def test_empty_and_degenerate_meshes():
    z = torch.zeros((3, 3))
    for tris in (torch.zeros((0, 3), dtype=torch.int64), torch.tensor([[0, 1, 2]])):
        compact = rt.build_raystab_compact7(z, tris, n=16)
        accel = rt.assemble_raystab_accel7(compact, z, tris, z)
        assert accel.main is None and compact.stats.live_tiles == 0
        assert compact.stats.dead_tiles == 16 ** 3 // 128
        occ, rgba = rt.raystab_query7(accel)
        assert occ.shape == (16, 16, 16) and rgba.shape == (16, 16, 16, 4)
        assert not bool(occ.any()) and not bool(rgba.any())
    with pytest.raises(ValueError):
        rt.build_raystab_compact7(z, tris, n=20)  # not a multiple of the tile


def test_use_tiled_raystab_contract(monkeypatch):
    """Gen-7 at n >= 128 and gen-6 below on a GPU, as JAX routes;
    DXRV_RAYSTAB_GEN=6|7 forces one, any other value is ignored."""
    for env in (None, "6", "7", "8"):
        if env is None:
            monkeypatch.delenv("DXRV_RAYSTAB_GEN", raising=False)
        else:
            monkeypatch.setenv("DXRV_RAYSTAB_GEN", env)
        for n in (32, 64, 128, 256, 512):
            assert rt.use_tiled_raystab(n) == jt.use_tiled_raystab(n), (env, n)
    monkeypatch.delenv("DXRV_RAYSTAB_GEN", raising=False)
    assert [rt.use_tiled_raystab(n) for n in (64, 128)] == [False, True]
