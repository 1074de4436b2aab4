"""Parity voxelization in the CUDA build against the JAX package on the CPU.

The same numpy meshes go through the JAX oracle / binned Pallas kernel
(interpret mode) and the port's oracle / binned path (the parity kernel's
plain version on the CPU); packed words must match bit for bit. The box has
its faces on voxel centers, so every boundary tie is exercised.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrvoxelizer_tpu.ops.binning import bin_triangles as jax_bin_triangles
from dxrvoxelizer_tpu.ops.binning import voxelize_parity_binned as jax_binned
from dxrvoxelizer_tpu.ops.geom import parity_tri_setup as jax_setup
from dxrvoxelizer_tpu.ops.packing import pack_bits_z as jax_pack
from dxrvoxelizer_tpu.ops.voxelize_pallas import (
    voxelize_parity_bruteforce as jax_bruteforce,
)
from dxrvoxelizer_tpu.ops.voxelize_ref import voxelize_parity_ref as jax_ref
from dxrvoxelizer_tpu_torch.core.pipeline import voxelize
from dxrvoxelizer_tpu_torch.models.mesh import MeshBuffers
from dxrvoxelizer_tpu_torch.ops import binning, packing, raystab_tiled, voxelize_cuda
from dxrvoxelizer_tpu_torch.ops.geom import parity_tri_setup
from dxrvoxelizer_tpu_torch.ops.voxelize_ref import voxelize_parity_ref
from tests.meshes import box_mesh, icosphere_mesh, tetrahedron_mesh
from tests.torch_cases import SOUP_TRIS, needle_soup

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


@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_words_bit_identical_to_jax(name, n):
    verts, _, tris = MESHES[name](n)
    jv, jt = jnp.asarray(verts), jnp.asarray(tris)
    want_ref = np.asarray(jax_pack(jax_ref(jv, jt, n=n)))
    want_bin = np.asarray(jax_binned(jv, jt, n=n, interpret=True))
    np.testing.assert_array_equal(want_bin, want_ref)

    tv, tt = _torch(verts, tris)
    got_ref = packing.pack_bits_z(voxelize_parity_ref(tv, tt, n=n)).numpy()
    got_bin = binning.voxelize_parity_binned(tv, tt, n).numpy()
    np.testing.assert_array_equal(got_ref, want_ref)
    np.testing.assert_array_equal(got_bin, want_ref)
    assert got_ref.any()


def test_parity_setup_bit_identical_to_jax():
    verts, _, tris = icosphere_mesh(3)
    want = jax_setup(jnp.asarray(verts), jnp.asarray(tris), 64)
    got = parity_tri_setup(*_torch(verts, tris), 64)
    for name, a, b in zip(got._fields, want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


@pytest.mark.parametrize("max_span", [1, 3])
def test_binned_tiles_match_jax(max_span):
    """Same capacity, same per-tile rows in the same order (max_span=1
    routes big triangles through the overflow list). The edge slopes and
    0/1 flags are differences of vertex coordinates, bit-identical in any
    order of evaluation, so they pin the rows. Inside its jitted binning
    phase XLA:CPU contracts the multiply-adds of the edge offsets and the
    depth plane, so those columns differ from the op-by-op ones by
    cancellation-scale amounts (the words above agree bit for bit)."""
    verts, _, tris = icosphere_mesh(3)
    want, wstats = jax_bin_triangles(jnp.asarray(verts), jnp.asarray(tris), 64,
                                     max_span=max_span)
    got, gstats = binning.bin_triangles(*_torch(verts, tris), 64,
                                        max_span=max_span)
    assert gstats == binning.BinStats(**vars(wstats))
    want = np.asarray(want)
    got = got.numpy()
    vc = voxelize_cuda
    exact = [vc._EX0, vc._EY0, vc._TL0, vc._EX1, vc._EY1, vc._TL1,
             vc._EX2, vc._EY2, vc._TL2, vc._VALID]
    np.testing.assert_array_equal(got[..., exact], want[..., exact])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    if max_span == 1:
        assert gstats.overflow > 0


def test_plain_kernel_on_bruteforce_tiles_matches_oracle():
    """Every tile sees every triangle (no binning): same words."""
    verts, _, tris = tetrahedron_mesh()
    tv, tt = _torch(verts, tris)
    coef = voxelize_cuda.pack_coeffs(parity_tri_setup(tv, tt, 64))
    tiles = coef[None].expand(4, -1, -1).contiguous()
    got = voxelize_cuda.voxelize_parity_tiles(tiles, 64)
    want = packing.pack_bits_z(voxelize_parity_ref(tv, tt, n=64))
    assert torch.equal(got, want)


@pytest.mark.parametrize("name,n", [("tet", 32), ("box", 64)])
def test_bruteforce_impl_matches_jax(name, n):
    """voxelize(impl="pallas_bruteforce"): every tile tests every triangle,
    as JAX's voxelize_parity_bruteforce does (its Pallas kernel in interpret
    mode here); the port's route takes the binned kernel's plain version on
    the CPU."""
    verts, nrm, tris = MESHES[name](n)
    want = np.asarray(jax_bruteforce(jnp.asarray(verts), jnp.asarray(tris), n,
                                     interpret=True))
    tv, tt = _torch(verts, tris)
    mesh = MeshBuffers(positions=tv, normals=torch.from_numpy(nrm), tris=tt,
                       positions_norm=tv)
    got = voxelize(mesh, n, impl="pallas_bruteforce").words
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()
    empty = voxelize_cuda.voxelize_parity_bruteforce(
        tv, torch.zeros((0, 3), dtype=torch.int64), n)
    assert empty.shape == (n, n, n // 32) and not empty.any()


def test_empty_and_far_meshes():
    verts, _, tris = box_mesh([4.0, 4.0, 4.0], [5.0, 5.0, 5.0])  # outside
    words = binning.voxelize_parity_binned(*_torch(verts, tris), 32)
    assert words.shape == (32, 32, 1) and not words.any()
    empty = binning.voxelize_parity_binned(
        torch.zeros((3, 3)), torch.zeros((0, 3), dtype=torch.int64), 32
    )
    assert not empty.any()


def test_pack_unpack_roundtrip_and_jax_layout():
    rng = np.random.default_rng(0)
    occ = rng.random((32, 32, 64)) > 0.5
    words = packing.pack_bits_z(torch.from_numpy(occ))
    np.testing.assert_array_equal(words.numpy(), np.asarray(jax_pack(jnp.asarray(occ))))
    back = packing.unpack_bits_z(words, 64).numpy()
    np.testing.assert_array_equal(back, occ)


def test_static_binned_voxelizer_and_voxelize_routes(monkeypatch):
    verts, nrm, tris = icosphere_mesh(3)
    tv, tt = _torch(verts, tris)
    mesh = MeshBuffers(positions=tv, normals=torch.from_numpy(nrm), tris=tt,
                       positions_norm=tv)
    sv = binning.StaticBinnedVoxelizer(tv, tt, 32)
    want = voxelize(mesh, 32, impl="xla").words  # CPU "auto" is the oracle
    assert torch.equal(voxelize(mesh, 32).words, want)
    assert torch.equal(voxelize(mesh, 32, impl="pallas").words, want)
    assert torch.equal(sv(), want)
    # the work-queue path (its kernel's plain version on the CPU)
    assert torch.equal(voxelize(mesh, 32, impl="queue").words, want)
    # ray-stab and -normals run on the CPU at every n (the JAX package's CPU
    # route, gen-1 and the MT oracle); on a GPU they take gen-7 at n >= 128,
    # as the JAX package does (its builder stubbed here: only the routing)
    assert torch.equal(voxelize(mesh, 32, with_normals=True).words, want)
    assert voxelize(mesh, 32, mode="raystab").rgba.shape == (32, 32, 32, 4)
    with pytest.raises(ValueError):
        voxelize(mesh, 32, impl="nope")

    class Routed(Exception):
        pass

    def gen7(*args, **kwargs):
        raise Routed

    monkeypatch.setattr(raystab_tiled, "build_raystab_accel7", gen7)
    tv4, tt4 = _torch(*tetrahedron_mesh()[::2])
    on_meta = [x.to("meta") for x in (tv4, tv4, tt4, tv4)]
    with pytest.raises(Routed):  # a stateless call routes by its tensors
        voxelize(MeshBuffers(*on_meta), 128, mode="raystab")
    tet = MeshBuffers(positions=tv4, normals=tv4, tris=tt4, positions_norm=tv4)
    # a mesh on the card (the -normals routing reads only its device)
    monkeypatch.setattr(MeshBuffers, "device",
                        property(lambda self: torch.device("cuda")))
    with pytest.raises(Routed):
        voxelize(tet, 128, with_normals=True, impl="xla")


def _assert_binned_crossings_inside_columns(verts, tris, n, max_span=3):
    """Every (column, row) crossing the plain version finds on the binned
    tiles lies in a real row (one before its tile's count) and among the
    columns the kernel tests for that row -> (crossings, sliver rows)."""
    coef, spans, counts, stats = binning.bin_triangles_spans(
        *_torch(verts, tris), n, max_span)
    want, _ = binning.bin_triangles(*_torch(verts, tris), n, max_span)
    assert torch.equal(coef, want)  # the JAX-shaped block is unchanged
    assert spans.dtype == torch.int16 and counts.dtype == torch.int32
    covered, _ = voxelize_cuda.tile_crossings(coef, n, slice(None))  # [t, l, k]
    cols = voxelize_cuda.row_columns(coef, spans, n)[:, None]  # [t, 1, k, 4]
    lane = torch.arange(voxelize_cuda.TILE ** 2)[None, :, None]
    xl, yl = lane // voxelize_cuda.TILE, lane % voxelize_cuda.TILE
    inside = ((cols[..., 0] <= xl) & (xl <= cols[..., 1])
              & (cols[..., 2] <= yl) & (yl <= cols[..., 3]))
    real = torch.arange(coef.shape[1])[None, :] < counts[:, None]
    assert not bool((coef[~real] != 0).any())  # past the count: padding only
    outside = covered & ~(inside & real[:, None, :])
    assert not bool(outside.any()), (
        f"{int(outside.sum())} crossings outside their row's columns")
    slivers = (voxelize_cuda.sliver_rows(coef.reshape(-1, 16),
                                         spans.reshape(-1, 4), n)
               & (coef.reshape(-1, 16)[:, 15] > 0))
    return int(covered.sum()), int(slivers.sum())


@pytest.mark.parametrize("max_span", [3, 1])
@pytest.mark.parametrize("name,n", [("box", 32), ("box", 64),
                                    ("icosphere3", 32), ("icosphere2", 64),
                                    ("soup287", 64), ("soup289", 64)])
def test_binned_crossings_lie_inside_row_columns(name, n, max_span):
    """The binned kernel's span rule on the binned rows: the box's faces lie
    on voxel centres (every edge tie fires on a span's boundary), the
    icospheres cover every orientation, and the needle soups (whose stray
    crossings fall outside the binning box) need the sliver rule; max_span
    1 sends most triangles through the overflow rows, appended to every
    tile."""
    if name.startswith("soup"):
        verts, tris = needle_soup(np.random.default_rng(int(name[4:])), n,
                                  SOUP_TRIS)
    elif name == "icosphere2":
        verts, _, tris = icosphere_mesh(2)
    else:
        verts, _, tris = MESHES[name](n)
    crossings, slivers = _assert_binned_crossings_inside_columns(
        verts, tris, n, max_span)
    assert crossings > 0
    assert (slivers > 0) == name.startswith("soup")
