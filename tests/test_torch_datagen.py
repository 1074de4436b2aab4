"""Batch datagen of the CUDA build (dxrvoxelizer_tpu_torch/parallel/
datagen.py) on the CPU: three procedural meshes written as OBJ files,
voxelized by every ``-impl`` (the kernels' plain versions here) and held
against the JAX package's ``datagen.voxelize_mesh_file(impl="xla")``, packed
words bit for bit; ``shard_paths``; and the CLI once."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dxrvoxelizer_tpu.parallel import datagen as jax_datagen
from dxrvoxelizer_tpu_torch.parallel import datagen
from tests.meshes import box_mesh, icosphere_mesh, tetrahedron_mesh

torch.set_num_threads(2)

N = 64


def _write_obj(path, v, t):
    lines = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in v]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in t]
    path.write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def objs(tmp_path_factory):
    d = tmp_path_factory.mktemp("meshes")
    meshes = {"tet": tetrahedron_mesh(),
              "box": box_mesh((-0.5, -0.25, -0.75), (0.5, 0.75, 0.25)),
              "ico": icosphere_mesh(3)}
    paths = []
    for name, (v, _, t) in meshes.items():
        p = d / f"{name}.obj"
        _write_obj(p, v, t)
        paths.append(str(p))
    return paths


@pytest.fixture(scope="module")
def jax_words(objs, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_out")
    words = []
    for p in objs:
        r = jax_datagen.voxelize_mesh_file(p, n=N, impl="xla", out_dir=out)
        words.append((np.load(r.out_file), r.occupied))
    return words


@pytest.mark.parametrize("impl", ["auto", "xla", "queue", "pallas"])
def test_voxelize_batch_matches_jax_xla(objs, jax_words, tmp_path, impl):
    """Every impl (auto = the oracle on the CPU) gives JAX's words and
    occupied counts; the saved .npy files hold the words."""
    results = datagen.voxelize_batch(objs, n=N, impl=impl, out_dir=tmp_path,
                                     devices=["cpu"])
    assert [r.path for r in results] == objs
    for r, (want, occ) in zip(results, jax_words):
        got = np.load(r.out_file)
        assert got.dtype == np.int32 and got.shape == (N, N, N // 32)
        assert np.array_equal(got, want)
        assert r.occupied == occ > 0 and r.n == N and r.device == "cpu"


def test_voxelize_mesh_file_and_round_robin(objs, jax_words, tmp_path):
    r = datagen.voxelize_mesh_file(objs[2], n=N, impl="xla", device="cpu")
    assert r.out_file is None and r.occupied == jax_words[2][1]
    # round-robin over a device list: mesh i on devices[i % 2]
    results = datagen.voxelize_batch(objs, n=N, impl="queue",
                                     devices=["cpu", "cpu"])
    assert [r.occupied for r in results] == [w[1] for w in jax_words]
    with pytest.raises(ValueError, match="unknown datagen impl"):
        datagen.voxelize_mesh_file(objs[0], n=N, impl="nope", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        datagen.voxelize_mesh_file(objs[0], n=N)  # the card by default


def test_shard_paths():
    paths = [f"m{i}.obj" for i in range(7)]
    assert datagen.shard_paths(paths) == paths  # no process group
    assert datagen.shard_paths(paths, 1, 3) == ["m1.obj", "m4.obj"]
    parts = [datagen.shard_paths(paths, i, 3) for i in range(3)]
    assert sorted(sum(parts, [])) == sorted(paths)
    assert datagen.shard_paths(paths, 1, 3) == jax_datagen.shard_paths(
        paths, 1, 3)


def test_datagen_cli(objs, jax_words, tmp_path, capsys):
    out = tmp_path / "cli"
    assert datagen.main([*objs, "-grid", str(N), "-out", str(out), "-warp"]) == 0
    text = capsys.readouterr().out
    assert f"3 meshes at {N}^3 on 1 device(s)" in text and "mesh/s" in text
    for p, (want, _) in zip(objs, jax_words):
        name = p.rsplit("/", 1)[-1].replace(".obj", f"_{N}.npy")
        assert np.array_equal(np.load(out / name), want)
