"""The port's benchmark (``dxrvoxelizer_tpu_torch/bench.py``) on the CPU.

- Its keys cover the JAX package's ``bench.py``'s, read from that file's
  source (it is not imported: it needs a TPU).
- Its entry function runs end to end at a tiny size on the CPU (the
  kernels' plain versions, the host clock): the JSON line parses, every
  expected key is there, none failed.
- The stand-in torus is closed and outward-wound, 100,000 triangles at full
  size, and its 32^3 words from the port equal the JAX package's counting
  oracle on the same vertices (op by op, ``jax.disable_jit``): empty in the
  hole, full in the tube.
- The plain queue version, which the bench holds the 1024^3 words against,
  gives the same words in tile groups of any size.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dxrvoxelizer_tpu.ops.voxelize_ref import voxelize_parity_ref as jax_oracle
from dxrvoxelizer_tpu_torch import bench
from dxrvoxelizer_tpu_torch.ops import _cuda
from dxrvoxelizer_tpu_torch.ops import voxelize_queue_cuda as vqc
from dxrvoxelizer_tpu_torch.ops.binning import voxelize_parity_binned
from dxrvoxelizer_tpu_torch.ops.packing import unpack_bits_z
from dxrvoxelizer_tpu_torch.ops.voxelize_queue import StaticVoxelizer, build_queue

torch.set_num_threads(2)

JAX_BENCH = Path(__file__).resolve().parents[1] / "bench.py"
# keys the port reports under another name (lane padding is TPU machinery)
RENAMED = {"raystab_accel64_phys_mib": "raystab_accel64_mib"}
# distinct sizes, so that no two entries share a key
TINY = bench.Sizes(n=64, render_n=32, hi=96, huge=128, width=64, height=36,
                   m=32, m_cap=64, stab=(32, 16, 24), torus=(40, 25))


def jax_bench_keys() -> set[str]:
    """The secondaries ``bench.py`` records at its full size (n = 256):
    every ``key=`` of its timing calls and every ``secondaries[...]``
    assignment, f-strings read with n = 256."""
    src = JAX_BENCH.read_text()
    found = re.findall(r'key=f?"([^"]+)"', src)
    found += re.findall(r'secondaries\[f?"([^"]+)"\]', src)
    keys = {k.replace("{n}", "256") for k in found}
    return {k for k in keys if "{" not in k}  # f"{key}_spread": any key


def test_bench_keys_cover_the_jax_bench():
    want = {RENAMED.get(k, k) for k in jax_bench_keys()}
    assert len(want) >= 30, sorted(want)
    assert "voxelize_256_ms" in want and "voxelize_1024_ms" in want
    have = set(bench.expected_keys())
    assert want <= have, sorted(want - have)
    # every timed key carries its spread
    for k in have:
        if k.endswith("_ms") and not k.endswith("_busy_ms"):
            assert f"{k}_spread" in have, k


@pytest.mark.parametrize("quick", [False, True], ids=["full", "quick"])
def test_bench_runs_on_the_cpu_at_a_tiny_size(quick, capsys):
    sizes = bench.Sizes(**{**TINY.__dict__, "quick": quick})
    line, failed = bench.run(sizes, device="cpu", reps=2, inner=1)
    assert failed == []
    parsed = json.loads(json.dumps(line))
    sec = parsed["secondaries"]
    assert not [k for k in sec if k.startswith("failed_")]
    assert sorted(sec) == sorted(bench.expected_keys(sizes, "cpu"))
    assert all(np.isfinite(v) and v >= 0 for v in sec.values())
    assert parsed["metric"] == "torus100k_voxelize_64cubed_ms"
    assert parsed["value"] == sec["voxelize_64_ms"] and parsed["unit"] == "ms"
    assert parsed["mesh"] == {"name": "torus100k", "triangles": 2000}
    assert parsed["device"] == "cpu"
    # the plain versions launch no kernel, and agree with themselves
    assert set(parsed["launches"].values()) == {0}
    assert parsed["max_abs_err"] == {"parity_queue": 0.0, "march": 0.0,
                                     "resolve": 0.0}
    # every check against the plain versions ran
    err = capsys.readouterr().err
    renders, words = (2, 1) if quick else (6, 4)
    assert err.count("march |err| 0 (bound") == renders, err
    assert err.count(" words differ from the plain version") == words, err


@pytest.mark.parametrize("fail", [False, True], ids=["ok", "failing"])
def test_bench_main_prints_the_line_last_and_exits_1_on_a_failure(
        monkeypatch, capsys, fail):
    real_run = bench.run
    monkeypatch.setattr(bench, "QUICK",
                        bench.Sizes(**{**TINY.__dict__, "quick": True}))
    monkeypatch.setattr(bench, "run", lambda s: real_run(s, device="cpu",
                                                         reps=1, inner=1))
    if fail:
        def mismatch(label, *args):
            raise RuntimeError(f"{label}: kernels disagree")

        monkeypatch.setattr(bench, "hold_render", mismatch)
    assert bench.main(["--quick"]) == (1 if fail else 0)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "torus100k_voxelize_64cubed_ms"
    failed = sorted(k for k in line["secondaries"] if k.startswith("failed_"))
    assert failed == (["failed_render32", "failed_render32_hq"] if fail else [])
    # a failed entry records no time; the others still run
    assert ("render_1080p_grid32_ms" in line["secondaries"]) != fail
    assert "light_sweep_32_ms" in line["secondaries"]


def test_all_kernels_lists_every_kernel_of_the_port():
    """``ops._cuda.all_kernels`` (the launches and errors of the bench and
    chip_smoke.py are keyed by it) holds every ``_cuda.Kernel`` the
    package defines, once."""
    pkg = Path(bench.__file__).resolve().parent
    defined = sum(len(re.findall(r"= _cuda\.Kernel\(", f.read_text()))
                  for f in pkg.rglob("*.py"))
    names = [k.name for k in _cuda.all_kernels()]
    assert len(names) == len(set(names)) == defined
    assert all(isinstance(k, _cuda.Kernel) for k in _cuda.all_kernels())


def _edges(tris: np.ndarray) -> np.ndarray:
    return np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])


@pytest.mark.parametrize("segments", [bench.TORUS_SEGMENTS, (40, 25)],
                         ids=["full", "small"])
def test_torus_is_closed_and_outward_wound(segments):
    v, t = bench.torus_mesh(segments)
    assert t.shape == (2 * segments[0] * segments[1], 3)
    if segments == bench.TORUS_SEGMENTS:
        assert t.shape[0] == 100_000
    # every directed edge once, and its reverse once: each edge is shared by
    # exactly two triangles that wind it in opposite directions
    e = _edges(t)
    key = e[:, 0] * len(v) + e[:, 1]
    rev = e[:, 1] * len(v) + e[:, 0]
    assert np.unique(key).size == key.size
    assert np.array_equal(np.sort(key), np.sort(rev))
    # signed volume of an outward-wound closed mesh: 2 pi^2 R r^2
    p = v[t].astype(np.float64)
    vol = np.einsum("ij,ij->i", p[:, 0], np.cross(p[:, 1], p[:, 2])).sum() / 6
    big, small = bench.TORUS_RADII
    assert vol > 0
    assert abs(vol / (2 * np.pi**2 * big * small**2) - 1) < 0.02
    # tilted off the grid axes, inside the normalized box
    assert np.abs(v).max() < 1.0
    assert np.abs(v[:, 2]).max() > 2 * small


def test_torus_words_match_the_jax_oracle():
    n = 32
    v, t = bench.torus_mesh((40, 25))
    with jax.disable_jit():
        want = np.asarray(jax_oracle(jnp.asarray(v), jnp.asarray(t, jnp.int32),
                                     n=n))
    vt, tt = torch.from_numpy(v), torch.from_numpy(t)
    for words in (StaticVoxelizer(vt, tt, n)(),
                  voxelize_parity_binned(vt, tt, n)):
        got = unpack_bits_z(words, n).numpy()
        assert np.array_equal(got, want), int((got != want).sum())
    # the hole at the centre is empty, the tube around the major circle full
    rx, rz = (np.array(m) for m in _tilt(bench.TORUS_TILT))
    big = bench.TORUS_RADII[0]

    def voxel(p):  # the grid's y runs downward (packing.voxel_centers_norm)
        return tuple(np.floor((p * [1, -1, 1] + 1.0) / 2.0 * n).astype(int))

    assert not want[voxel(np.zeros(3))]
    for u in np.linspace(0.0, 2 * np.pi, 8, endpoint=False):
        c = rz @ rx @ np.array([big * np.cos(u), big * np.sin(u), 0.0])
        assert want[voxel(c)], u
    assert 0.05 < want.mean() < 0.3


def _tilt(tilt):
    ax, az = tilt
    rx = [[1, 0, 0], [0, np.cos(ax), -np.sin(ax)], [0, np.sin(ax), np.cos(ax)]]
    rz = [[np.cos(az), -np.sin(az), 0], [np.sin(az), np.cos(az), 0],
          [0, 0, 1]]
    return rx, rz


@pytest.mark.parametrize("tiles_per_group", [1, 3, 50])
def test_plain_queue_words_in_tile_groups(monkeypatch, tiles_per_group):
    n = 64
    v, t = bench.torus_mesh((40, 25))
    coefs, _, ct, cn, _, _ = build_queue(torch.from_numpy(v),
                                         torch.from_numpy(t), n)
    whole = vqc.voxelize_parity_queue_chunks_plain(coefs, ct, cn, n)
    group = vqc.voxelize_parity_queue_chunks_plain(coefs, ct, cn, n, 5, 20)
    monkeypatch.setattr(vqc, "PLAIN_HIST", tiles_per_group * 128 * (n + 1))
    assert torch.equal(vqc.voxelize_parity_queue_chunks_plain(coefs, ct, cn, n),
                       whole)
    assert torch.equal(
        vqc.voxelize_parity_queue_chunks_plain(coefs, ct, cn, n, 5, 20), group)
    assert torch.equal(group, whole.reshape(n // 16, 16, n // 8, 8, n // 32)
                       .permute(0, 2, 4, 1, 3).reshape(-1, n // 32, 128)[5:25])
