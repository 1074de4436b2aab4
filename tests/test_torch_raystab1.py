"""The gen-1 ray-stab accel of the CUDA build (one cubemap level, the
Moller-Trumbore closest-hit kernel) against the JAX package on the CPU.

The same numpy meshes go through both packages: the binning, the ray tables
and the candidate rows (bit for bit against JAX's own build); the kernel's
plain version (against the Pallas ``stab_closest_hit`` in interpret mode);
the whole query (against JAX's XLA query and the Moller-Trumbore oracle);
the CPU frame's grids (against JAX's own CPU ``FramePipeline``), and a
ray-stab call at 128^3 (against the oracle). The box has its faces on voxel centres (ties on every
boundary; there the MT and radial oracles differ in 527 voxels); the
near-origin soup overflows 300 triangles, which JAX pads to O = 320.

The JAX side runs op by op (``jax.disable_jit``), as the port runs: jitted,
XLA:CPU contracts multiply-adds into FMAs. The Pallas interpret kernel is
always compiled, so it is compared on tables whose arithmetic is exact:
power-of-two determinants, so the reciprocal is exact, and short-mantissa
coordinates, so every product and sum is.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dxrvoxelizer_tpu.core.pipeline as jpl
import dxrvoxelizer_tpu.ops.raystab_fast as jrf
from dxrvoxelizer_tpu.models.mesh import MeshBuffers as JaxMeshBuffers
from dxrvoxelizer_tpu.ops.raystab_pallas import stab_closest_hit
from dxrvoxelizer_tpu.utils import native
from dxrvoxelizer_tpu.utils.config import VoxelizerConfig as JaxConfig
from dxrvoxelizer_tpu_torch.core import pipeline as ppl
from dxrvoxelizer_tpu_torch.core.pipeline import FramePipeline, voxelize
from dxrvoxelizer_tpu_torch.models.mesh import MeshBuffers
from dxrvoxelizer_tpu_torch.ops import intersect
from dxrvoxelizer_tpu_torch.ops import raystab_fast as rf
from dxrvoxelizer_tpu_torch.ops import raystab_mt_cuda as rmt
from dxrvoxelizer_tpu_torch.ops import voxelize_ref as vr
from dxrvoxelizer_tpu_torch.state import raystab_accel_from_numpy
from dxrvoxelizer_tpu_torch.utils.config import VoxelizerConfig
from tests.meshes import box_mesh, icosphere_mesh, tetrahedron_mesh
from tests.torch_cases import mt_stress_groups

torch.set_num_threads(2)


def _box_on_centers(n):
    c = [(i + 0.5) / n * 2.0 - 1.0 for i in (3, 5, 2, n - 6, n - 4, n - 9)]
    return box_mesh(c[:3], c[3:])


def _near_origin():
    """300 triangles straddling the origin: all overflow (JAX: O = 320)."""
    rng = np.random.default_rng(11)
    nt = 300
    centers = rng.standard_normal((nt, 1, 3)).astype(np.float32) * 0.02
    offsets = rng.standard_normal((nt, 3, 3)).astype(np.float32) * 0.3
    tri_v = centers + offsets
    fn = np.cross(tri_v[:, 1] - tri_v[:, 0], tri_v[:, 2] - tri_v[:, 0])
    fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
    normals = np.repeat(fn, 3, axis=0).astype(np.float32)
    tris = np.arange(nt * 3, dtype=np.int32).reshape(nt, 3)
    return tri_v.reshape(-1, 3), normals, tris


# name -> (mesh, n)
CASES = {
    "tet16": (tetrahedron_mesh, 16),
    "icosphere2_32": (lambda: icosphere_mesh(2), 32),
    "box_on_centers32": (lambda: _box_on_centers(32), 32),
    "near_origin16": (_near_origin, 16),
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


def _same(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture
def jax_python_path(monkeypatch):
    """JAX's accel build through its numpy paths: no native code, no
    on-disk ray-table cache."""
    monkeypatch.setenv("DXRVOX_RAYTAB_CACHE", "off")
    for fn in ("accel_pack_tables_native", "accel_pack_native",
               "raytab_native", "dir_cells_native"):
        monkeypatch.setattr(native, fn, lambda *a, **k: None)
    jrf._ray_table_filled.cache_clear()
    jrf.ray_tables.cache_clear()
    yield
    jrf._ray_table_filled.cache_clear()
    jrf.ray_tables.cache_clear()


# cells per step of JAX's XLA query: a few large steps, since op by op each
# step costs its operations' dispatch (the result does not depend on it)
CELL_CHUNK = 2048


@functools.cache
def _jax_accel(name):
    """JAX's gen-1 accel, built as JAX builds it (jitted cone binning)."""
    v, _, t = _jax(name)
    return jrf.build_raystab_accel(v, t, CASES[name][1], cell_chunk=CELL_CHUNK)


@functools.cache
def _jax_query(name):
    """JAX's XLA query on its own accel, op by op -> numpy (occ, rgba)."""
    v, nr, t = _jax(name)
    with jax.disable_jit():
        occ, rgba = jrf.raystab_query(v, nr, t, _jax_accel(name), impl="xla",
                                      cell_chunk=CELL_CHUNK)
    return np.asarray(occ), np.asarray(rgba)


# ---- the build ------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_bins_ray_tables_and_rows_match_jax(jax_python_path, name):
    v, _, t = _port(name)
    jv, _, jt = _jax(name)
    n = CASES[name][1]
    cand_ids, cand_off, ov_ids, stats = rf.bin_triangles_radial(v, t)
    table, counts, ov_j, stats_j = jrf.bin_triangles_radial(jv, jt)
    assert stats == rf.RadialBinStats(**dataclasses.asdict(stats_j))
    assert _same(np.diff(cand_off), counts)
    assert _same(rf._cell_table_host(cand_ids, cand_off, np.diff(cand_off),
                                     stats.capacity), table)
    ov_j = np.asarray(ov_j)
    assert _same(ov_ids, ov_j[ov_j >= 0])
    ray_ids, ray_off = rf.ray_tables(n, 32)
    rt, _ = jrf.ray_tables(n, 32)
    assert _same(ray_ids, rt[rt >= 0])
    assert _same(np.diff(ray_off), (rt >= 0).sum(axis=1))
    assert _same(rf._mt_rows(v, t).numpy(),
                 jrf._dense_coefs(jv, jt, jnp.arange(t.shape[0])))
    if name == "near_origin16":
        assert stats.overflow == 300 and ov_j.shape == (320,)


# ---- the kernel's plain version against the Pallas kernel -------------------------

T_COUNT = 5000
_POW2 = np.array([0.25, 0.5, 1.0, 2.0])


def _exact_tables(seed, c, k, shared=False):
    """JAX-layout tables (rays [C, 8, 128]: o, d, valid, pad; coefs [C, K, 12]
    or [K, 12]: v0 e1 e2 id pad pad) whose arithmetic is exact in f32.

    Each triangle lies in a coordinate plane of an axis permutation P:
    e1 = a P(x) + c P(y), e2 = b P(y), with a, b powers of two, so
    det = -a b d_P(z) is a power of two (or 0: a miss) for directions whose
    components are powers of two or 0; origins, v0 and c lie on a 1/8 grid.
    Padding lanes, padding candidates, duplicate rows (exact t ties broken by
    the lower id), shared planes, edge and vertex hits and t = +-0 included.
    """
    rng = np.random.default_rng(seed)
    mag = np.array([0.0, 0.125, 0.25, 0.5, 1.0])
    d = mag[rng.integers(0, 5, (c, 3, 128))] * rng.choice([-1.0, 1.0], (c, 3, 128))
    d[:, 2][(d == 0).all(axis=1)] = 0.5  # a real lane is never all zero
    o = rng.integers(-8, 9, (c, 3, 128)) / 8.0
    pad = rng.random((c, 128)) < 0.1
    d = np.where(pad[:, None], 0.0, d)
    o = np.where(pad[:, None], 0.0, o)
    valid = (~pad)[:, None].astype(np.float64)
    rays = np.concatenate([o, d, valid, np.zeros((c, 1, 128))], 1).astype(np.float32)

    cs = 1 if shared else c
    a = _POW2[rng.integers(0, 4, (cs, k))] * rng.choice([-1.0, 1.0], (cs, k))
    b = _POW2[rng.integers(0, 4, (cs, k))] * rng.choice([-1.0, 1.0], (cs, k))
    cc = rng.integers(-8, 9, (cs, k)) / 8.0
    perm = np.array([[0, 1, 2], [1, 2, 0], [2, 0, 1], [1, 0, 2]])[
        rng.integers(0, 4, (cs, k))]  # P(x), P(y), P(z) per row
    e1 = np.zeros((cs, k, 3))
    e2 = np.zeros((cs, k, 3))
    np.put_along_axis(e1, perm[..., 0:1], a[..., None], -1)
    np.put_along_axis(e1, perm[..., 1:2], cc[..., None], -1)
    np.put_along_axis(e2, perm[..., 1:2], b[..., None], -1)
    v0 = rng.integers(-8, 9, (cs, k, 3)) / 8.0
    # few planes: many rows share one, so their hits tie in t
    plane = rng.integers(-2, 3, (cs, k)) / 4.0
    np.put_along_axis(v0, perm[..., 2:3], plane[..., None], -1)
    g = np.concatenate([v0, e1, e2], -1)
    dup = rng.random((cs, k)) < 0.1
    src = rng.integers(0, k, (cs, k))
    g = np.where(dup[..., None], np.take_along_axis(g, src[..., None], 1), g)
    ids = np.stack([rng.permutation(T_COUNT)[:k] for _ in range(cs)])
    if shared:
        ids = np.sort(ids, axis=1)  # the overflow rows ascend by id
    coefs = np.concatenate([g, ids[..., None], np.zeros((cs, k, 2))], -1)
    lo = k // 2 if k > 256 else 1
    cnt = rng.integers(lo, k + 1, cs)
    if shared:
        cnt[:] = k
    live = np.arange(k)[None, :] < cnt[:, None]
    coefs = np.where(live[..., None], coefs, 0.0)
    coefs[..., 9] = np.where(live, coefs[..., 9], 2.0**30)
    coefs = coefs.astype(np.float32)
    return rays, (coefs[0] if shared else coefs), cnt


def _port_tables(rays, coefs, cnt) -> rmt.MTTables:
    """The same tables as the port's slice stream: every lane is a ray."""
    c = rays.shape[0]
    pos = np.ascontiguousarray(rays[:, 0:3].transpose(0, 2, 1).reshape(-1, 3))
    dirs = np.ascontiguousarray(rays[:, 3:6].transpose(0, 2, 1).reshape(-1, 3))
    shared = coefs.ndim == 2
    if shared:
        rows, cand_off = coefs, np.zeros(c)
        cand_cnt = np.full(c, coefs.shape[0])
    else:
        rows = np.concatenate([coefs[s, :cnt[s]] for s in range(c)])
        cand_off = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        cand_cnt = cnt

    def i32(x):
        return torch.from_numpy(np.asarray(x, np.int32))

    return rmt.MTTables(
        pos=torch.from_numpy(pos), dirs=torch.from_numpy(dirs),
        ray_ids=i32(np.arange(c * 128)),
        ray_off=i32(np.arange(c) * 128), ray_cnt=i32(np.full(c, 128)),
        cand_off=i32(cand_off), cand_cnt=i32(cand_cnt),
        rows=torch.from_numpy(np.ascontiguousarray(rows, np.float32)))


@pytest.mark.parametrize("layout", ["cells48", "shared40"])
def test_mt_plain_bit_identical_to_pallas(layout):
    """closest_hit_plain against stab_closest_hit in interpret mode: per-cell
    candidate lists, and the shared variant."""
    shared = layout == "shared40"
    k = 40 if shared else 48
    rays, coefs, cnt = _exact_tables(3, 16, k, shared=shared)
    want_t, want_i = stab_closest_hit(jnp.asarray(rays), jnp.asarray(coefs), k,
                                      shared=shared, interpret=True)
    t, i = rmt.closest_hit_plain(_port_tables(rays, coefs, cnt))
    assert _same(t.numpy(), np.asarray(want_t).reshape(-1))
    assert _same(i.numpy(), np.asarray(want_i).reshape(-1))
    hit = np.isfinite(t.numpy())
    assert 0.2 < hit.mean() < 0.95  # hits, misses and padding lanes
    assert bool((t.numpy() == 0.0).any())  # origins on a triangle's plane


def test_mt_plain_chunks_bit_identical_to_brute_force():
    """Lists of two 256-candidate chunks (the plain version's chunk merge)
    against JAX's ``_overflow_pass`` brute force (``intersect.closest_hit``,
    bit-identical to JAX's: ties to the lowest row) over each cell's rows in
    ascending id order."""
    rays, coefs, cnt = _exact_tables(5, 8, 512)
    tb = _port_tables(rays, coefs, cnt)
    t, i = rmt.closest_hit_plain(tb)
    assert int(cnt.min()) > 256  # every list spans two chunks
    for s in range(rays.shape[0]):
        rows = coefs[s, :cnt[s]]
        rows = torch.from_numpy(rows[np.argsort(rows[:, 9])])
        sl = slice(s * 128, (s + 1) * 128)
        bt, _, _, bi = intersect.closest_hit(tb.pos[sl], tb.dirs[sl], rows[:, 0:3],
                                             rows[:, 3:6], rows[:, 6:9])
        ids = torch.where(torch.isfinite(bt), rows[bi.long(), 9].to(torch.int32),
                          intersect.BIG_ID)
        assert torch.equal(t[sl], bt) and torch.equal(i[sl], ids)
    assert 0.2 < float(torch.isfinite(t).float().mean()) < 0.99


def test_kernel_wrapper_takes_the_plain_version_on_cpu():
    rays, coefs, cnt = _exact_tables(9, 8, 48)
    tb = _port_tables(rays, coefs, cnt)
    before = rmt.KERNEL.launches
    for a, b in zip(rmt.closest_hit(tb), rmt.closest_hit_plain(tb)):
        assert torch.equal(a, b)
    assert rmt.KERNEL.launches == before
    bad = dataclasses.replace(tb, rows=tb.rows[:, :9])
    with pytest.raises(ValueError):
        rmt.closest_hit(bad)
    # the overflow layout (every slice against all the rows) in any row
    # order: the (t, lowest id) minimum does not depend on it
    ov = _port_tables(*_exact_tables(9, 8, 40, shared=True))
    flipped = dataclasses.replace(ov, rows=ov.rows.flip(0).contiguous())
    for a, b in zip(rmt.closest_hit(flipped), rmt.closest_hit(ov)):
        assert torch.equal(a, b)
    assert rmt.KERNEL.launches == before


def _rejects_and_hits(o, d, rows):
    """(pairs rejected before the division, hits, both, hits whose u is
    -0.0) of rays o, d [R, 3] against rows [K, >= 9]."""
    o, d, q = o[:, None], d[:, None], rows[None]
    _, u, _, hit = intersect.mt_hit(o, d, q[..., 0:3], q[..., 3:6], q[..., 6:9])
    rej = rmt.mt_rejects(o, d, q[..., 0:3], q[..., 3:6], q[..., 6:9])
    neg0 = hit & (u == 0) & torch.signbit(u)
    return (int(rej.sum()), int(hit.sum()), int((rej & hit).sum()),
            int(neg0.sum()))


def test_mt_rejects_never_reject_a_hit():
    """The Moller-Trumbore kernel's rejects that need no division
    (``mt_rejects``, its plain replica) never reject a pair ``mt_hit``
    accepts: on the stress stream's groups (det near 1e-10, u and v that
    underflow to -0.0, u + v within a few ulp of 1, t ties and t at its
    bounds) and on every real (ray, candidate) pair of a gen-1 accel at
    32^3; there they reject most pairs."""
    totals = np.zeros(4, np.int64)
    for o, d, rows in mt_stress_groups().values():
        if len(rows):
            totals += _rejects_and_hits(torch.from_numpy(o), torch.from_numpy(d),
                                        torch.from_numpy(rows))
    assert totals[2] == 0 and totals[1] > 0 and totals[0] > 0
    assert totals[3] > 0  # a hit whose u rounds to -0.0 is not rejected
    v, _, t = icosphere_mesh(4)
    tb = rf.build_raystab_accel(torch.from_numpy(v),
                                torch.from_numpy(t.astype(np.int64)), n=32).main
    totals = np.zeros(4, np.int64)
    for s in range(tb.slices):
        r0, rc, c0, cc = (int(x[s]) for x in (tb.ray_off, tb.ray_cnt,
                                               tb.cand_off, tb.cand_cnt))
        if rc and cc:
            rid = tb.ray_ids[r0:r0 + rc].long()
            totals += _rejects_and_hits(tb.pos[rid], tb.dirs[rid],
                                        tb.rows[c0:c0 + cc])
    pairs = int((tb.ray_cnt.long() * tb.cand_cnt.long()).sum())
    assert totals[2] == 0 and totals[1] > 0
    assert totals[0] > 0.8 * pairs  # most pairs leave before dividing (88 %)


# ---- the query ------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_query_bit_identical_to_jax_xla_query_and_mt_oracle(jax_python_path, name):
    """raystab_query (the kernel's plain version on the CPU) on the port's
    accel and on JAX's accel carried across, against JAX's XLA query run op
    by op and the port's Moller-Trumbore oracle: occupancy and the
    unquantized rgba."""
    v, nr, t = _port(name)
    n = CASES[name][1]
    accel = rf.build_raystab_accel(v, t, n=n)
    occ, rgba = rf.raystab_query(v, nr, t, accel)
    want = _jax_query(name)
    assert _same(occ.numpy(), want[0]) and _same(rgba.numpy(), want[1])
    mt = vr.voxelize_raystab_ref(v, nr, t, n=n)
    assert torch.equal(occ, mt[0]) and torch.equal(rgba, mt[1])
    ja = _jax_accel(name)
    carried = raystab_accel_from_numpy(
        v, t, ja.n, ja.g, [tuple(np.asarray(a) for a in c) for c in ja.classes],
        np.asarray(ja.ov_ids), dataclasses.asdict(ja.stats))
    assert carried.stats == accel.stats
    got = rf.raystab_query(v, nr, t, carried)
    assert torch.equal(got[0], occ) and torch.equal(got[1], rgba)
    plain = rf.raystab_query(v, nr, t, accel, impl="xla")
    assert torch.equal(plain[0], occ) and torch.equal(plain[1], rgba)
    assert bool(occ.any())
    assert (accel.ov is not None) == (accel.stats.overflow > 0)


def test_query_options_empty_and_degenerate_meshes():
    v, nr, t = _port("tet16")
    accel = rf.build_raystab_accel(v, t, n=16)
    with pytest.raises(ValueError):
        rf.raystab_query(v, nr, t, accel, impl="fast")
    with pytest.raises(ValueError):
        rf.raystab_query(v, nr, t[:2], accel)
    z = torch.zeros((3, 3))
    for tris in (torch.zeros((0, 3), dtype=torch.int64), torch.tensor([[0, 1, 2]])):
        acc = rf.build_raystab_accel(z, tris, n=16)
        occ, rgba = rf.raystab_query(z, z, tris, acc)
        assert not bool(occ.any()) and not bool(rgba.any())
        assert occ.shape == (16, 16, 16) and rgba.shape == (16, 16, 16, 4)
        assert acc.ov is None and acc.main.rows.shape[0] == 0
        occ, rgba = rf.voxelize_raystab_fast(z, z, tris, n=16)
        assert not bool(occ.any()) and not bool(rgba.any())


# ---- the CPU routing --------------------------------------------------------------

W, H, N = 96, 64, 32


@pytest.mark.parametrize("mode", ["raystab", "normals"])
def test_cpu_frame_grid_bit_identical_to_jax_pipeline(monkeypatch, jax_python_path,
                                                     mode):
    """The port's CPU FramePipeline grid (-inside raystab: the gen-1 accel;
    -normals: the parity oracle's words and the Moller-Trumbore oracle under
    rule "hit") against JAX's own CPU FramePipeline run op by op, on the box
    with faces on voxel centres, where the MT and radial oracles differ."""
    v, nr, t = _mesh("box_on_centers32")
    grids = {}

    def capture(key):
        def render(grid, consts, cfg, impl="warp", **kw):
            grids[key] = grid
            return torch.zeros((H, W, 3)) if key == "port" else jnp.zeros((H, W, 3))
        return render

    monkeypatch.setattr(jpl, "render", capture("jax"))
    monkeypatch.setattr(ppl, "render", capture("port"))
    kw = dict(grid_size=N, width=W, height=H,
              inside_mode="raystab" if mode == "raystab" else "parity",
              parity_normals=mode == "normals")
    jmesh = JaxMeshBuffers(positions=jnp.asarray(v), normals=jnp.asarray(nr),
                           tris=jnp.asarray(t), positions_norm=jnp.asarray(v))
    with jax.disable_jit():
        jpl.FramePipeline(JaxConfig(**kw), jmesh).frame(None)
    tv = torch.from_numpy(v)
    mesh = MeshBuffers(positions=tv, normals=torch.from_numpy(nr),
                       tris=torch.from_numpy(t.astype(np.int64)), positions_norm=tv)
    pipe = FramePipeline(VoxelizerConfig(**kw), mesh)
    pipe.frame(None)
    want, got = grids["jax"], grids["port"]
    assert _same(got.words.numpy(), want.words)
    assert _same(got.rgba.numpy(), want.rgba)
    accel = pipe._stab_accel
    if mode == "raystab":
        assert isinstance(accel, rf.RaystabAccel)  # gen-1 on the CPU
    else:
        assert accel is None  # the oracle, no accel
    # the radial rule would differ here: the fault this routing repairs
    radial = vr.voxelize_raystab_radial_ref(tv, mesh.normals, mesh.tris, n=N,
                                            rule="backface" if mode == "raystab"
                                            else "hit")
    mt = vr.voxelize_raystab_ref(tv, mesh.normals, mesh.tris, n=N,
                                 rule="backface" if mode == "raystab" else "hit")
    assert int(mt[0].sum()) == 12672 and int((radial[0] != mt[0]).sum()) == 527


@pytest.mark.parametrize("impl", ["fast", "queue", "pallas"])
def test_accel_impl_names_route_as_jax(monkeypatch, jax_python_path, impl):
    """voxelize(mode="raystab") takes the JAX package's accel names ("fast",
    "queue", "pallas") as "auto": with a gen-1 accel both packages run its
    query, and the grids are JAX's (JAX's query, op by op, is the one the
    query test above holds the port to); "pallas_bruteforce" raises in both."""
    name = "icosphere2_32"  # JAX packs the words: n a multiple of 32
    n = CASES[name][1]
    want = _jax_query(name)
    ran = []

    def query(*a, **kw):  # JAX's routing, with its op-by-op query's result
        ran.append(kw)
        return jnp.asarray(want[0]), jnp.asarray(want[1])

    monkeypatch.setattr(jrf, "raystab_query", query)
    jv, jn, jt = _jax(name)
    jmesh = JaxMeshBuffers(positions=jv, normals=jn, tris=jt, positions_norm=jv)
    jgrid = jpl.voxelize(jmesh, n, mode="raystab", impl=impl, quantize=False,
                         accel=_jax_accel(name))
    assert len(ran) == 1
    v, nr, t = _port(name)
    mesh = MeshBuffers(positions=v, normals=nr, tris=t, positions_norm=v)
    accel = rf.build_raystab_accel(v, t, n=n)
    got = voxelize(mesh, n, mode="raystab", impl=impl, quantize=False,
                   accel=accel)
    assert _same(got.words.numpy(), jgrid.words)
    assert _same(got.rgba.numpy(), jgrid.rgba)
    for vox in (jpl.voxelize, voxelize):
        with pytest.raises(ValueError):
            vox(jmesh if vox is jpl.voxelize else mesh, n, mode="raystab",
                impl="pallas_bruteforce")


def test_cpu_raystab_at_128_runs_and_matches_jax():
    """A stateless CPU ray-stab call at 128^3 (gen-7 on a GPU) runs gen-1,
    as the JAX package's CPU call does, and equals it: the grid
    is the Moller-Trumbore oracle's, which is JAX's own oracle bit for bit
    (test_torch_raystab.py), as JAX's gen-1 query is (the query test above,
    at 16^3 and 32^3). JAX's query itself is not run here: op by op at
    128^3 it costs more than the rest of this file."""
    v, nr, t = (torch.from_numpy(np.asarray(a, np.float32)) for a in
                icosphere_mesh(0, radius=0.1, center=(0.5, 0.3, -0.4)))
    mesh = MeshBuffers(positions=v, normals=nr, tris=t.long(), positions_norm=v)
    grid = voxelize(mesh, 128, mode="raystab", quantize=False)
    occ, rgba = vr.voxelize_raystab_ref(v, nr, t.long(), n=128)
    assert torch.equal(grid.occupancy(), occ)
    assert torch.equal(grid.rgba, rgba)
    assert int(occ.sum()) > 500
