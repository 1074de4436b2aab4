"""The ray-stab accel's per-triangle rows (X.9, ``csrc/refit_rows.cu``) on
the CPU.

The kernel runs only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py`` phase 22c hold it against its plain version there, bit
for bit). Here:

- its numpy mirror (``raystab_fast.fused_rows_mirror``: a thread a row, each
  product, difference and sum one float32 rounding in the kernel's order,
  six 16-byte stores a row) against the port's ``_fused_coef_matrix`` (the
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


@pytest.mark.parametrize("bad", ["float64", "int16", "triangles"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch, bad):
    """Vertices and normals must be float32 (nothing is cast), triangles
    int64 or int32, fewer than 2^24 of them; the checks run before a
    launch."""
    def require(t, name, dtype, shape=None, contiguous=True):
        if t.dtype != dtype:  # the meta tensors pass as the card's
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")

    monkeypatch.setattr(_cuda, "require", require)
    monkeypatch.setattr(_cuda, "load", lambda: pytest.fail("launched"))
    if bad == "float64":
        args, match = _meta(dtype=torch.float64), "float32"
    elif bad == "int16":
        args, match = _meta(tris=torch.int16), "int64 or int32"
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
        calls.append(a[0].shape)
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
    rows = [a.main.rows for a in frames]
    assert rows[0] is not rows[1]
    for s, r in zip((1.01, 0.99), rows):
        assert torch.equal(r, rf._fused_coef_matrix(v * s, t, nr))
