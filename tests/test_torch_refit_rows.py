"""The ray-stab accel's per-triangle rows (X.9, ``csrc/refit_rows.cu``) on
the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase 22c hold it against its plain version there, bit
for bit). Here:

- its numpy mirror (``raystab_fast.fused_rows_mirror``: block by block, the
  index run staged in 16-byte units, a thread a row, each product,
  difference and sum one float32 rounding in the kernel's order, the
  block's rows stored as one run) against the port's ``_fused_coef_matrix`` (the
  plain version) and the JAX package's, run op by op under
  ``jax.disable_jit()`` (jitted, XLA:CPU contracts the products and sums
  into FMAs), bit for bit: the box with faces on voxel centres, the
  icosphere, the needle soups of ``tests/torch_cases.py`` and the padding
  row;
- the routing: a CPU tensor and ``use_kernel=False`` take the plain
  version, a tensor that is not on the CPU goes to the kernel or raises
  (no fallback, no cast), and the refitters and the accel builds call the
  wrapper.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dxrvoxelizer_tpu.ops.raystab_fast as jrf
from dxrvoxelizer_tpu_torch.ops import _cuda, raystab_refit, raystab_tiled
from dxrvoxelizer_tpu_torch.ops import raystab_fast as rf
from tests.meshes import box_mesh, icosphere_mesh
from tests.torch_cases import SOUP_SEEDS, SOUP_TRIS, needle_soup

torch.set_num_threads(2)

N = 64


def _mesh(name):
    """(verts, normals, tris) numpy: the box with faces on voxel centres at
    64^3, the icosphere, or a needle soup with seeded normals."""
    if name == "box":
        c = [(i + 0.5) / N * 2 - 1 for i in (3, 5, 2, N - 6, N - 4, N - 9)]
        return box_mesh(c[:3], c[3:])
    if name == "icosphere":
        return icosphere_mesh(3)
    rng = np.random.default_rng(int(name[4:]))
    v, t = needle_soup(rng, N, SOUP_TRIS)
    return v, rng.standard_normal(v.shape).astype(np.float32), t


MESHES = ["box", "icosphere", *(f"soup{s}" for s in SOUP_SEEDS)]


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


@pytest.mark.parametrize("mesh", MESHES)
def test_mirror_equals_the_plain_chain_and_jax(mesh):
    """X.9's mirror == the port's ``_fused_coef_matrix`` == JAX's op by op,
    every bit (int64 and int32 triangles)."""
    v, nr, t = _mesh(mesh)
    v, nr = np.asarray(v, np.float32), np.asarray(nr, np.float32)
    got = rf.fused_rows_mirror(v, t, nr)
    for tt in (t.astype(np.int64), t.astype(np.int32)):
        assert np.array_equal(_bits(rf.fused_rows_mirror(v, tt, nr)),
                              _bits(got))
        plain = rf._fused_coef_matrix(torch.from_numpy(v),
                                      torch.from_numpy(tt),
                                      torch.from_numpy(nr)).numpy()
        assert np.array_equal(_bits(got), _bits(plain))
    with jax.disable_jit():
        want = np.asarray(jrf._fused_coef_matrix(
            jnp.asarray(v), jnp.asarray(t.astype(np.int32)), jnp.asarray(nr)))
    assert np.array_equal(_bits(got), _bits(want))


def test_padding_row_and_an_empty_mesh():
    """The last row is zero but its id column, 2^30 (a miss that loses
    every tie); a mesh with no triangle is that row alone."""
    v, nr, t = _mesh("icosphere")
    rows = rf.fused_rows_mirror(np.asarray(v, np.float32), t,
                                np.asarray(nr, np.float32))
    pad = np.zeros(24, np.float32)
    pad[10] = 2.0 ** 30
    assert np.array_equal(_bits(rows[-1]), _bits(pad))
    assert np.array_equal(rows[:-1, 10], np.arange(t.shape[0], dtype=np.float32))
    empty = np.zeros((0, 3), np.int64)
    got = rf.fused_rows_mirror(np.zeros((0, 3), np.float32), empty,
                               np.zeros((0, 3), np.float32))
    plain = rf._fused_coef_matrix(torch.zeros((0, 3)), torch.from_numpy(empty),
                                  torch.zeros((0, 3))).numpy()
    assert np.array_equal(_bits(got), _bits(pad[None]))
    assert np.array_equal(_bits(plain), _bits(pad[None]))


def _placed(a: np.ndarray, aligned: bool) -> np.ndarray:
    """A copy of ``a`` whose data starts 16-byte aligned, or not."""
    flat = np.empty(a.size + 16, a.dtype)
    for k in range(16):
        if (flat[k:].ctypes.data % 16 == 0) == aligned:
            out = flat[k:k + a.size].reshape(a.shape)
            out[...] = a
            return out
    raise AssertionError("no such placement")


@pytest.mark.parametrize("t_count", [1, 127, 255, 256, 257, 300, 511, 700])
def test_mirror_blocks_tails_and_widths(t_count):
    """X.9's mirror block by block, where T + 1 rows fill the last block of
    ROWS_BLOCK (127, 255, 511) or leave it a remainder, on int64 and int32
    triangles that start 16-byte aligned (16-byte index units and a 4-byte
    tail): every row stored once, == the plain chain and JAX's op by op,
    bit for bit; triangles that do not start 16-byte aligned are refused
    (ValueError), as the wrapper refuses them."""
    rng = np.random.default_rng(t_count)
    v = rng.standard_normal((97, 3)).astype(np.float32)
    nr = rng.standard_normal((97, 3)).astype(np.float32)
    t = rng.integers(0, 97, (t_count, 3))
    want = rf._fused_coef_matrix(torch.from_numpy(v), torch.from_numpy(t),
                                 torch.from_numpy(nr)).numpy()
    with jax.disable_jit():
        jax_rows = np.asarray(jrf._fused_coef_matrix(
            jnp.asarray(v), jnp.asarray(t.astype(np.int32)), jnp.asarray(nr)))
    assert np.array_equal(_bits(want), _bits(jax_rows))
    for dtype in (np.int64, np.int32):
        got = rf.fused_rows_mirror(v, _placed(t.astype(dtype), True), nr)
        assert not np.isnan(got).any()
        assert np.array_equal(_bits(got), _bits(want))
        with pytest.raises(ValueError, match="16-byte aligned"):
            rf.fused_rows_mirror(v, _placed(t.astype(dtype), False), nr)


def test_mirror_traps_on_an_index_out_of_range():
    """An index outside [0, V) of the vertices or of the normals: the
    kernel traps before reading through it, the mirror raises."""
    v, nr, t = _mesh("icosphere")
    v, nr = np.asarray(v, np.float32), np.asarray(nr, np.float32)
    for bad, verts, normals in ((-1, v, nr), (v.shape[0], v, nr),
                                (v.shape[0] - 1, v, nr[:-1])):
        tt = np.array(t, np.int64)
        tt[-1, 1] = bad
        with pytest.raises(IndexError):
            rf.fused_rows_mirror(verts, tt, normals)


def _meta(t_count=10, dtype=torch.float32, tris=torch.int64):
    return (torch.empty((t_count, 3), dtype=dtype, device="meta"),
            torch.empty((t_count, 3), dtype=tris, device="meta"),
            torch.empty((t_count, 3), dtype=dtype, device="meta"))


def test_cpu_and_use_kernel_false_take_the_plain_version():
    """A CPU tensor and ``use_kernel=False`` (on a meta tensor) take the
    plain chain and count no launch; with the kernel asked for, the meta
    tensor goes to the kernel and raises."""
    before = rf.REFIT_ROWS.launches
    v, nr, t = (torch.from_numpy(np.asarray(a)) for a in _mesh("icosphere"))
    assert torch.equal(rf.fused_coef_matrix(v, t.long(), nr),
                       rf._fused_coef_matrix(v, t.long(), nr))
    out = rf.fused_coef_matrix(*_meta(), use_kernel=False)
    assert out.device.type == "meta" and tuple(out.shape) == (11, 24)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        rf.fused_coef_matrix(*_meta())
    assert rf.REFIT_ROWS.launches == before


@pytest.mark.parametrize("bad", ["float64", "int16", "triangles",
                                 "unaligned"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch, bad):
    """Vertices and normals must be float32 (nothing is cast), triangles
    int64 or int32, fewer than 2^24 of them, starting 16-byte aligned; the
    checks run before a launch."""
    def require(t, name, dtype, shape=None, contiguous=True):
        if t.dtype != dtype:  # the meta tensors pass as the card's
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")

    monkeypatch.setattr(_cuda, "require", require)
    monkeypatch.setattr(_cuda, "load", lambda: pytest.fail("launched"))
    if bad == "float64":
        args, match = _meta(dtype=torch.float64), "float32"
    elif bad == "int16":
        args, match = _meta(tris=torch.int16), "int64 or int32"
    elif bad == "unaligned":  # a view one int32 into its allocation
        v, _, nr = _meta()
        tris = torch.empty(31, dtype=torch.int32, device="meta")[1:]
        args, match = (v, tris.view(10, 3), nr), "16-byte aligned"
    else:
        args, match = _meta(t_count=2 ** 24), "2\\^24"
    with pytest.raises(ValueError, match=match):
        rf.fused_coef_matrix(*args)


@pytest.mark.parametrize("failure", ["build", "launch"])
def test_a_kernel_that_fails_raises(monkeypatch, failure):
    """A library that fails to build or an entry point that returns a CUDA
    error raises; nothing falls back and no launch is counted."""
    class Lib:
        def __getattr__(self, name):
            return lambda *a: 700  # cudaErrorIllegalAddress

    def load():
        if failure == "build":
            raise RuntimeError("nvcc not found: the CUDA toolkit is required")
        return Lib()

    monkeypatch.setattr(_cuda, "require", lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "load", load)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda dev: 0)
    before = rf.REFIT_ROWS.launches
    with pytest.raises(RuntimeError, match="nvcc|CUDA error 700"):
        rf.fused_coef_matrix(*_meta())
    assert rf.REFIT_ROWS.launches == before


@pytest.mark.parametrize("gen", [6, 7])
def test_refits_and_builds_call_the_wrapper(monkeypatch, gen):
    """The refitters (every frame) and the accel builds take the rows from
    ``fused_coef_matrix`` (X.9 on a CUDA tensor), and a refit's rows are
    the deformed mesh's: a fresh matrix each frame."""
    calls = []
    wrapper = rf.fused_coef_matrix

    def spy(*a, **k):
        calls.append((a[0].shape, a[1].dtype))
        return wrapper(*a, **k)

    for mod in (rf, raystab_refit, raystab_tiled):
        monkeypatch.setattr(mod, "fused_coef_matrix", spy)
    v, nr, t = (torch.from_numpy(np.asarray(a)) for a in icosphere_mesh(2))
    t = t.long()
    cls = (raystab_tiled.RaystabTiledRefitter if gen == 7
           else raystab_refit.RaystabRefitter)
    fitter = cls(v, t, nr, n=32, pad=0.02)
    assert len(calls) == 1  # the rest build
    frames = [fitter.refit(v * s, nr) for s in (1.01, 0.99)]
    assert len(calls) == 3
    # a refit reads the int32 copy of the triangles made at construction
    assert [c[1] for c in calls[1:]] == [torch.int32, torch.int32]
    rows = [a.main.rows for a in frames]
    assert rows[0] is not rows[1]
    for s, r in zip((1.01, 0.99), rows):
        assert torch.equal(r, rf._fused_coef_matrix(v * s, t, nr))
