"""The native C++ host tier of the CUDA build (dxrvoxelizer_tpu_torch/
utils/native.py, built by g++ at first use): the OBJ tokenizer against the
Python parser, the PNG encoder against the stdlib one, and the gen-6 accel
build's pack walk, ray table and direction cells against their Python
versions, bit for bit."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dxrvoxelizer_tpu_torch.ops import raystab_fast as rf
from dxrvoxelizer_tpu_torch.utils import native
from dxrvoxelizer_tpu_torch.utils.image import encode_png, read_png, write_png
from dxrvoxelizer_tpu_torch.utils.objloader import load_obj
from tests.meshes import box_mesh, icosphere_mesh, tetrahedron_mesh

torch.set_num_threads(2)


def test_every_native_library_builds():
    """g++ (and zlib) are on this machine and on the card's: the native
    tier builds, into the package's git-ignored build directory."""
    for name in ("objparse", "pngwrite", "accelpack"):
        info = native.build(name)
        assert info is not None, name
        assert info.path.parent.name == "_build" and info.path.is_file()


def _assert_same_mesh(a, b):
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.normals, b.normals)
    np.testing.assert_array_equal(a.aabb_min, b.aabb_min)
    np.testing.assert_array_equal(a.aabb_max, b.aabb_max)


def _write(path, verts, tris, normals=None):
    lines = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in verts]
    if normals is None:
        lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in tris]
    else:
        lines += [f"vn {x:.9g} {y:.9g} {z:.9g}" for x, y, z in normals]
        lines += [f"f {a + 1}//{a + 1} {b + 1}//{b + 1} {c + 1}//{c + 1}"
                  for a, b, c in tris]
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("case", ["tet", "box", "ico_normals", "synthetic"])
def test_native_obj_parser_matches_python(tmp_path, case):
    """The tokenizer + the shared post-processing equal the Python parser
    exactly: procedural meshes with and without normals, and a file with
    comments, fans, vt records and negative indices."""
    p = tmp_path / f"{case}.obj"
    if case == "tet":
        v, _, t = tetrahedron_mesh()
        _write(p, v, t)
    elif case == "box":
        v, _, t = box_mesh((-0.5, -0.4, -0.3), (0.6, 0.5, 0.4))
        _write(p, v, t)
    elif case == "ico_normals":
        v, nrm, t = icosphere_mesh(2)
        _write(p, v, t, normals=nrm)
    else:
        p.write_text(
            "# comment\nv 0 0 0\nv 1 0 0\nv 1 1 0.5\nv 0 1 -0.25\n"
            "vt 0 0\nvn 0 0 1\nvn 0 1 0\n"
            "f 1/1/1 2/1/1 3/1/1 4/1/2\nf -4//-2 -3//-2 -2//-1\n")
    _assert_same_mesh(load_obj(p, impl="native"), load_obj(p, impl="python"))
    _assert_same_mesh(load_obj(p), load_obj(p, impl="python"))


@pytest.mark.parametrize("ch", [1, 3, 4])
def test_native_png_decodes_to_the_stdlib_pixels(tmp_path, ch):
    rng = np.random.default_rng(7 + ch)
    img = rng.integers(0, 256, size=(37, 53, ch), dtype=np.uint8)
    img[5:20, 10:40] = 17  # runs the filters' flat case too
    p = tmp_path / f"n{ch}.png"
    assert native.write_png_native(p, img)
    (tmp_path / f"s{ch}.png").write_bytes(encode_png(img))
    back = read_png(p)
    assert np.array_equal(back, img)
    assert np.array_equal(back, read_png(tmp_path / f"s{ch}.png"))


def test_write_png_takes_the_native_encoder(tmp_path, monkeypatch):
    """write_png goes through the native encoder (a float image quantized
    as the stdlib path quantizes it) and falls back to Python without it."""
    img = np.linspace(0, 1, 32 * 48 * 3, dtype=np.float32).reshape(32, 48, 3)
    expect = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    calls = []
    real = native.write_png_native
    monkeypatch.setattr(native, "write_png_native",
                        lambda path, im: calls.append(1) or real(path, im))
    write_png(tmp_path / "a.png", img)
    assert calls and np.array_equal(read_png(tmp_path / "a.png"), expect)
    monkeypatch.setattr(native, "write_png_native", lambda path, im: False)
    write_png(tmp_path / "b.png", img)
    assert np.array_equal(read_png(tmp_path / "b.png"), expect)


@pytest.mark.parametrize("n, g", [(32, 8), (32, 16), (64, 16), (64, 32)])
def test_native_ray_table_and_cells_match_python(n, g):
    rt_n, rc_n = native.raytab_native(n, g)
    rt_p, rc_p = rf._ray_table_filled_py(n, g)
    assert rt_n.dtype == rt_p.dtype and rc_n.dtype == rc_p.dtype
    assert np.array_equal(rt_n, rt_p) and np.array_equal(rc_n, rc_p)
    cx, cy, cz = rf.voxel_centers_norm(n)
    pos = np.stack(np.meshgrid(cx, cy, cz, indexing="ij"), -1).reshape(-1, 3)
    assert np.array_equal(native.dir_cells_native(n, g),
                          rf._dir_cells_host(pos, g))


@pytest.mark.parametrize("n, gs", [(32, None), (64, None), (32, (4,))])
@pytest.mark.parametrize("pad", [0.0, 0.02])
def test_native_pack_walk_matches_python_on_icosphere(monkeypatch, n, gs,
                                                      pad):
    """The accel build's own pack-walk inputs (the icosphere's fine-cell
    candidate CSR, the ray table, the triangle bounds), captured from
    build_raystab_compact2 at the default ladder and at a coarse one whose
    cells hold more than one strip of rays: the native walk's CSR quadruple
    equals the Python walk's, bit for bit, with and without the bounds; and
    the compact the build makes with the native walk is the Python
    walk's."""
    v, nrm, t = icosphere_mesh(3)
    verts, tris = torch.from_numpy(v), torch.from_numpy(t.astype(np.int64))
    seen = []
    real = rf._make_packs
    monkeypatch.setattr(rf, "_make_packs",
                        lambda *a: seen.append(a) or real(*a))
    native_compact = rf.build_raystab_compact2(verts, tris, n=n, gs=gs,
                                               pad=pad)
    (cell_csr, ray_table, rc, tri_bounds), = seen
    assert tri_bounds is not None and (rc > 128).any() == (gs is not None)
    for bounds in (tri_bounds, None):
        got = native.accel_pack_native(*cell_csr, ray_table, rc, bounds)
        want = rf._make_packs_py(cell_csr, ray_table, rc, bounds)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    monkeypatch.setattr(rf, "_make_packs", rf._make_packs_py)
    py_compact = rf.build_raystab_compact2(verts, tris, n=n, gs=gs, pad=pad)
    assert len(native_compact.classes) == len(py_compact.classes)
    for (a_rt, a_tab, a_b), (b_rt, b_tab, b_b) in zip(native_compact.classes,
                                                      py_compact.classes):
        assert np.array_equal(a_rt, b_rt) and np.array_equal(a_tab, b_tab)
        assert (a_b is None) == (b_b is None)
        assert a_b is None or np.array_equal(a_b, b_b)


def test_native_pack_walk_refuses_short_bounds():
    offs = np.array([0, 2], np.int64)
    data = np.array([0, 5], np.int64)
    rt = np.zeros((1, 8), np.int32)
    with pytest.raises(ValueError, match="tri_bounds"):
        native.accel_pack_native(offs, data, rt, np.array([1], np.int64),
                                 np.zeros(3))
