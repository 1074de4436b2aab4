"""The work-queue parity voxelizer of the CUDA build against the JAX package
on the CPU.

The same numpy meshes go through the JAX queue path (its Pallas kernel in
interpret mode, as tests/test_voxelize_queue.py runs it) and the port's
(the queue kernel's plain version on CPU tensors). Packed words must match
bit for bit; the queue layout (chunk arrays, QueueStats) must be equal. The
box has its faces on voxel centers, so every boundary tie is exercised.

The JAX queue builds run op by op (``jax.disable_jit``), as the port runs:
inside a jitted build XLA:CPU contracts the multiply-adds of the triangle
setup into FMAs, which moves boundary decisions — 3 voxels of the
tetrahedron at 128^3 differ between the jitted and the op-by-op JAX build
(ROADMAP.md, section 3). Op by op the coefficient rows are bit-identical.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dxrvoxelizer_tpu.core.pipeline import voxelize as jax_voxelize
from dxrvoxelizer_tpu.ops.geom import parity_tri_setup as jax_tri_setup
from dxrvoxelizer_tpu.models.mesh import MeshBuffers as JaxMeshBuffers
from dxrvoxelizer_tpu.ops import voxelize_queue as jvq
from dxrvoxelizer_tpu_torch.app.main import wobbled
from dxrvoxelizer_tpu_torch.core.pipeline import FramePipeline, render, voxelize
from dxrvoxelizer_tpu_torch.models.mesh import MeshBuffers
from dxrvoxelizer_tpu_torch.ops import voxelize_cuda
from dxrvoxelizer_tpu_torch.ops import voxelize_queue as vq
from dxrvoxelizer_tpu_torch.ops import voxelize_queue_cuda as vqc
from dxrvoxelizer_tpu_torch.ops.packing import pack_bits_z
from dxrvoxelizer_tpu_torch.ops.voxelize_ref import voxelize_parity_ref
from dxrvoxelizer_tpu_torch.state import grid_from_numpy, queue_from_numpy
from dxrvoxelizer_tpu_torch.utils.config import VoxelizerConfig
from tests.meshes import box_mesh, icosphere_mesh, tetrahedron_mesh
from tests.torch_cases import needle_soup as _soup

torch.set_num_threads(2)


def _box_on_centers(n):
    c = [(i + 0.5) / n * 2.0 - 1.0 for i in (3, 5, 2, n - 6, n - 4, n - 9)]
    return box_mesh(c[:3], c[3:])


MESHES = {
    "box": _box_on_centers,
    "tet": lambda n: tetrahedron_mesh(),
    "icosphere3": lambda n: icosphere_mesh(3),
}


def _torch(verts, tris):
    return (torch.from_numpy(np.asarray(verts, np.float32)),
            torch.from_numpy(np.asarray(tris, np.int64)))


def _jax(verts, tris):
    return jnp.asarray(verts, jnp.float32), jnp.asarray(tris, jnp.int32)


def _jax_queue(verts, tris, n, **kw):
    """JAX's build_queue, run op by op (see the module docstring)."""
    with jax.disable_jit():
        return jvq.build_queue(*_jax(verts, tris), n, **kw)


def _jax_words(queue, n):
    """JAX's queue kernel (interpret mode) on a JAX-built queue."""
    return np.asarray(jvq.voxelize_parity_queue_run(
        queue[0], *(np.asarray(a) for a in queue[1:4]), n, interpret=True))


def _wobble(verts, normals, frame):
    """The app's -deform wobble (JAX app/main.py) in float32 numpy."""
    t = frame / 15.0
    amp = 0.03 * np.sin(2 * np.pi * t + verts[:, :1] * 5.0)
    return (verts + amp * normals).astype(np.float32)


@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_queue_words_bit_identical_to_jax(name, n):
    verts, _, tris = MESHES[name](n)
    want = _jax_words(_jax_queue(verts, tris, n), n)
    tv, tt = _torch(verts, tris)
    got = vq.voxelize_parity_queue(tv, tt, n)
    assert got.dtype == torch.int32 and got.shape == (n, n, n // 32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()
    # and the port's own counting oracle, an independent reduction
    assert torch.equal(got, pack_bits_z(voxelize_parity_ref(tv, tt, n=n)))


def test_static_voxelizer_bit_identical_to_jax():
    verts, _, tris = icosphere_mesh(3)
    n = 64
    with jax.disable_jit():  # the build, op by op
        jsv = jvq.StaticVoxelizer(*_jax(verts, tris), n, interpret=True)
    want = np.asarray(jsv())
    sv = vq.StaticVoxelizer(*_torch(verts, tris), n)
    for _ in range(2):  # build once, run per frame
        np.testing.assert_array_equal(sv().numpy(), want)


@pytest.mark.parametrize("max_span", [(1, 1), (4, 8)])
def test_build_queue_matches_jax(max_span):
    """Same QueueStats and chunk arrays, the same coefficient rows in the
    same order (max_span (1, 1) routes most triangles through overflow):
    bit-identical to the op-by-op JAX build. Against the jitted build, the
    edge slopes and 0/1 flags are bit-identical in any order of evaluation;
    XLA:CPU contracts the multiply-adds of the edge offsets and the depth
    plane, so those columns agree to cancellation-scale amounts (the rule
    of tests/test_torch_voxelize.py for the binned rows)."""
    verts, _, tris = icosphere_mesh(3)
    n = 64
    spans = {"max_span_x": max_span[0], "max_span_y": max_span[1]}
    c, _, ct, cn, cl, stats = vq.build_queue(*_torch(verts, tris), n, **spans)
    eager = _jax_queue(verts, tris, n, **spans)
    jitted = jvq.build_queue(*_jax(verts, tris), n, **spans)
    vc = voxelize_cuda
    exact = [vc._EX0, vc._EY0, vc._TL0, vc._EX1, vc._EY1, vc._TL1,
             vc._EX2, vc._EY2, vc._TL2, vc._VALID]
    for jc, jct, jcn, jcl, jstats in (eager, jitted):
        assert stats == vq.QueueStats(**vars(jstats))
        for got, want in ((ct, jct), (cn, jcn), (cl, jcl)):
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(c.numpy()[:, exact],
                                      np.asarray(jc)[:, exact])
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-4,
                                   atol=1e-3)
    np.testing.assert_array_equal(c.numpy(), np.asarray(eager[0]))
    if max_span == (1, 1):
        assert stats.overflow > 0


def test_overflow_path_bit_identical_to_jax():
    verts, _, tris = _box_on_centers(128)
    n = 128
    jq = _jax_queue(verts, tris, n, max_span_x=1, max_span_y=1)
    assert jq[-1].overflow > 0
    want = _jax_words(jq, n)
    c, _, ct, cn, _, stats = vq.build_queue(*_torch(verts, tris), n,
                                            max_span_x=1, max_span_y=1)
    assert stats.overflow == jq[-1].overflow
    got = vqc.voxelize_parity_queue_chunks(c, ct, cn, n)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()


def test_plain_kernel_on_jax_queue_gives_jax_words():
    """A queue built by the JAX package, carried across as numpy, gives the
    JAX kernel's words bit for bit through the port's plain version."""
    verts, _, tris = _box_on_centers(64)
    n = 64
    jc, jct, jcn, jcl, _ = jvq.build_queue(*_jax(verts, tris), n)  # jitted
    want = _jax_words((jc, jct, jcn, jcl), n)
    c, ct, cn, cl = queue_from_numpy(np.asarray(jc), np.asarray(jct),
                                     np.asarray(jcn), np.asarray(jcl), n, "cpu")
    assert cl.dtype == torch.int32
    got = vqc.voxelize_parity_queue_chunks(c, ct, cn, n)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        queue_from_numpy(np.asarray(jc)[:, :8], np.asarray(jct),
                         np.asarray(jcn), np.asarray(jcl), n, "cpu")
    # the kernel walks each tile's chunks back to back, padding chunks last
    with pytest.raises(ValueError, match="non-decreasing"):
        queue_from_numpy(np.asarray(jc), np.asarray(jct)[::-1].copy(),
                         np.asarray(jcn), np.asarray(jcl), n, "cpu")


def test_empty_mesh():
    v, t = torch.zeros((0, 3)), torch.zeros((0, 3), dtype=torch.int64)
    want = np.asarray(jvq.voxelize_parity_queue(
        jnp.zeros((0, 3), jnp.float32), jnp.zeros((0, 3), jnp.int32), 64))
    got = vq.voxelize_parity_queue(v, t, 64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got.any()
    dv = vq.DeformingVoxelizer(v, t, 64)
    assert not dv(v, check=True).any()


def test_suffix_parity_words_matches_jax():
    rng = np.random.default_rng(3)
    words = rng.integers(-2**31, 2**31, size=(5, 4, 16), dtype=np.int64
                         ).astype(np.int32)
    want = np.asarray(jvq.suffix_parity_words(jnp.asarray(words)))
    got = vq.suffix_parity_words(torch.from_numpy(words))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_rest_mesh_spans_match_jax(name):
    for n in (64, 128):
        verts, _, tris = MESHES[name](n)
        assert vq.rest_mesh_spans(*_torch(verts, tris), n) == \
            jvq.rest_mesh_spans(*_jax(verts, tris), n)


def test_deforming_voxelizer_bit_identical_to_jax():
    """The device-built queue and the words match the JAX package's
    DeformingVoxelizer on the rest pose and two wobbled poses. JAX's
    ``__call__`` is its device build plus one kernel launch over every
    tile; the build runs op by op here (module docstring), the kernel in
    interpret mode."""
    verts, nrm, tris = icosphere_mesh(3)
    n = 64
    with jax.disable_jit():
        jdv = jvq.DeformingVoxelizer(*_jax(verts, tris), n, interpret=True)
    assert jdv.n_groups == 1
    dv = vq.DeformingVoxelizer(*_torch(verts, tris), n)
    assert (dv.num_chunks, dv.spans) == (jdv.num_chunks, jdv.spans)
    for frame in (None, 3, 11):
        v = verts if frame is None else _wobble(verts, nrm, frame)
        with jax.disable_jit():
            jq = jvq._build_queue_device(jnp.asarray(v), jdv.tris, n,
                                         jdv.num_chunks, 64, *jdv.spans)
        assert bool(jq[-1])
        want = np.asarray(jvq._tiles_to_grid(jvq._queue_run_group(
            *jq[:4], jnp.zeros((1,), jnp.int32), n, 64, jdv.n_tiles,
            static_trip=True, interpret=True), n))
        q = dv.build(torch.from_numpy(v))
        # coefficient rows, chunk arrays, ok word (JAX carries no spans)
        for a, b in zip((q[0], *q[2:]), jq, strict=True):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        got = dv(torch.from_numpy(v), check=True)
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(got, vq.voxelize_parity_queue(
            torch.from_numpy(v), dv.tris, n))


def test_deforming_overflow_raises_on_check():
    verts, _, tris = icosphere_mesh(3)
    tv, tt = _torch(verts, tris)
    # a small rest pose sizes the span caps and the capacity; the full-size
    # pose outgrows them (more span-overflow triangles than OV_CAP_DEVICE)
    dv = vq.DeformingVoxelizer(tv * 0.2, tt, 64)
    assert bool(dv.build(tv * 0.2)[-1])
    assert not bool(dv.build(tv)[-1])
    with pytest.raises(RuntimeError, match="overflowed its capacity"):
        dv(tv, check=True)


def test_frame_pipeline_deforming_matches_jax_oracle():
    """FramePipeline(deforming=True) on the CPU, frame by frame with the
    app's wobble, voxelizes as the JAX package's oracle does on the same
    deformed positions (the CPU routes to the oracle, as JAX's does)."""
    verts, nrm, tris = icosphere_mesh(2)
    tv, tt = _torch(verts, tris)
    tn = torch.from_numpy(nrm)
    n = 32
    base = MeshBuffers(positions=tv, normals=tn, tris=tt, positions_norm=tv)
    cfg = VoxelizerConfig(grid_size=n, width=48, height=32, render_ss=1)
    pipe = FramePipeline(cfg, base, deforming=True)
    consts = _consts(cfg)
    for frame in range(3):
        pipe.mesh = wobbled(base, verts[:, :1], frame)
        v = _wobble(verts, nrm, frame)
        np.testing.assert_array_equal(pipe.mesh.positions_norm.numpy(), v)
        jmesh = JaxMeshBuffers(positions=jnp.asarray(v), normals=jnp.asarray(nrm),
                               tris=jnp.asarray(tris), positions_norm=jnp.asarray(v))
        want = np.asarray(jax_voxelize(jmesh, n, impl="xla").words)
        got = voxelize(pipe.mesh, n, impl="queue").words
        np.testing.assert_array_equal(got.numpy(), want)
        # the frame's own grid is JAX's: its image is the render of it
        img = pipe.frame(consts)
        assert torch.equal(img, render(grid_from_numpy(want, "cpu"), consts, cfg))


def _consts(cfg):
    from dxrvoxelizer_tpu_torch.models.camera import OrbitCamera
    from dxrvoxelizer_tpu_torch.models.scene import Scene
    from dxrvoxelizer_tpu_torch.utils.objloader import ObjMesh

    v, nrm, t = tetrahedron_mesh()
    scene = Scene(ObjMesh(positions=v, normals=nrm, indices=t.reshape(-1),
                          aabb_min=v.min(0), aabb_max=v.max(0)), "cpu")
    cam = OrbitCamera(cfg.width, cfg.height)
    return scene.update_frame(cam.eye, cam.view_proj, cfg.width, cfg.height)


# ---- the column spans the kernel restricts each row to -----------------------

def _jax_row_tris(verts, tris, n, num_chunks, **spans):
    """The triangle of each row of JAX's queue (-1: a padding row), by JAX's
    own layout: its device build with each coefficient row replaced by its
    triangle's id + 1 (integers only: jitted, nothing contracts)."""
    @jax.jit
    def rows(v, t):
        coef, *rest = jvq._queue_phase_a(v, t, n, spans.get("max_span_x", 4),
                                         spans.get("max_span_y", 8))
        ids = jnp.zeros_like(coef).at[:, 0].set(
            jnp.arange(coef.shape[0], dtype=jnp.float32) + 1.0)
        return jvq._assemble_window((ids, *rest), n, num_chunks, vq.K_CHUNK,
                                    0, None)[0]
    return np.asarray(rows(*_jax(verts, tris)))[:, 0].astype(np.int64) - 1


@pytest.mark.parametrize("max_span", [(4, 8), (1, 1)])
@pytest.mark.parametrize("name,n", [("box", 64), ("icosphere3", 128),
                                    ("soup", 64)])
def test_queue_spans_equal_jax_binning_spans(name, n, max_span):
    """Each row's span is the column range JAX's _queue_phase_a bins its
    triangle by ([ceil xmin, floor xmax] x [ceil ymin, floor ymax], from
    JAX's own setup), clipped to [-1, N]; padding rows get (-1, -1, -1, -1).
    (1, 1) routes most triangles through the overflow list, appended to
    every tile."""
    verts, tris = (_soup(np.random.default_rng(5), n, 16) if name == "soup"
                   else MESHES[name](n)[::2])
    kw = {"max_span_x": max_span[0], "max_span_y": max_span[1]}
    c, spans, ct, cn, _, stats = vq.build_queue(*_torch(verts, tris), n, **kw)
    assert spans.dtype == torch.int16 and spans.shape == (c.shape[0], 4)
    row_tri = _jax_row_tris(verts, tris, n, stats.num_chunks, **kw)
    # the bounds are single roundings and the ceil/floor exact: jitted is exact
    pt = jax.jit(jax_tri_setup, static_argnums=2)(*_jax(verts, tris), n)
    box = np.stack([np.ceil(pt.xmin), np.floor(pt.xmax),
                    np.ceil(pt.ymin), np.floor(pt.ymax)], axis=1)
    want = np.where(row_tri[:, None] >= 0,
                    np.clip(box, -1, n)[np.maximum(row_tri, 0)], -1)
    np.testing.assert_array_equal(spans.numpy(), want)
    # the rows are those of the port's queue, in JAX's layout
    live = row_tri >= 0
    assert live.sum() == stats.pairs
    assert (c.numpy()[~live] == 0).all() and (c.numpy()[live, 15] > 0).all()
    if max_span == (1, 1):
        assert stats.overflow > 0


def _assert_crossings_inside_spans(verts, tris, n, **kw):
    """Every (row, column) crossing the plain version finds lies in the
    row's span clipped to its tile -> the number of crossings."""
    c, spans, ct, cn, _, stats = vq.build_queue(*_torch(verts, tris), n, **kw)
    covered, _ = vqc.queue_crossings(c, ct, cn, n, slice(None))  # [ch, 128, k]
    sp = vqc.row_columns(c, spans, ct, n).reshape(ct.shape[0], 1, -1, 4)
    lane = torch.arange(vqc.LANES)[None, :, None]
    xl, yl = lane // vqc.TILE_Y, lane % vqc.TILE_Y
    inside = ((sp[..., 0] <= xl) & (xl <= sp[..., 1])
              & (sp[..., 2] <= yl) & (yl <= sp[..., 3]))
    outside = covered & ~inside
    assert not bool(outside.any()), (
        f"{int(outside.sum())} crossings outside their row's span")
    slivers = vqc.sliver_rows(c, spans, n) & (c[:, 15] > 0)
    return int(covered.sum()), int(slivers.sum())


@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("name", ["box", "icosphere2"])
def test_plain_crossings_lie_inside_row_spans(name, n):
    """The box's faces lie on voxel centres (every edge tie fires on the
    span's boundary); an icosphere covers every orientation. No row of
    either is a sliver: each tests its span widened by one column."""
    verts, _, tris = (_box_on_centers(n) if name == "box"
                      else icosphere_mesh(2))
    for kw in ({}, {"max_span_x": 1, "max_span_y": 1}):
        crossings, slivers = _assert_crossings_inside_spans(verts, tris, n, **kw)
        assert crossings > 0 and slivers == 0


@settings(max_examples=12, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2**32 - 1), n=st.sampled_from([32, 64]),
       overflow=st.booleans())
def test_soup_crossings_lie_inside_row_spans(seed, n, overflow):
    """Hypothesis soups of slivers and near-degenerate triangles (with
    span caps of 1 x 1 tiles, most of them go through the overflow list).
    Without the sliver rule a needle's float32 coverage escapes its box
    widened by one column: seed 1219099752 at 64^3 covers a column four
    columns past it."""
    verts, tris = _soup(np.random.default_rng(seed), n, 24)
    kw = {"max_span_x": 1, "max_span_y": 1} if overflow else {}
    crossings, slivers = _assert_crossings_inside_spans(verts, tris, n, **kw)
    assert slivers > 0
