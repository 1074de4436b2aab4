"""Guards of the CUDA build (dxrvoxelizer_tpu_torch): it never imports JAX,
never falls back from CUDA to the CPU silently, and its kernel wrappers
refuse what they cannot launch."""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from dxrvoxelizer_tpu_torch.ops import (
    _cuda,
    march_cuda,
    raymarch_fast,
    raystab_cuda,
    raystab_mt_cuda,
    screen_warp_cuda,
    voxelize_cuda,
    voxelize_queue_cuda,
)
from dxrvoxelizer_tpu_torch.utils.config import parse_args
from dxrvoxelizer_tpu_torch.utils.device import select_device

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "dxrvoxelizer_tpu_torch"


def _modules() -> list[str]:
    mods = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__main__":
            continue  # running it starts the app
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_every_module_imports_without_jax_and_builds_nothing():
    mods = _modules()
    for m in ("ops.voxelize_cuda", "ops.voxelize_queue", "ops.voxelize_queue_cuda",
              "ops.intersect", "ops.raystab_fast", "ops.raystab_cuda",
              "ops.raystab_mt_cuda", "ops.raymarch_fast", "ops.raymarch_ref",
              "ops.sampling", "ops.mips", "utils.profiling", "state",
              "app.main", "app.interactive", "app.preview", "parallel.mesh",
              "parallel.shard", "parallel.raystab_shard", "parallel.pipeline",
              "parallel.datagen", "entry", "utils.native"):
        assert f"dxrvoxelizer_tpu_torch.{m}" in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('dxrvoxelizer_tpu.') or m == 'dxrvoxelizer_tpu')\n"
        "assert not bad, bad\n"
        "from dxrvoxelizer_tpu_torch.ops import _cuda\n"
        "assert _cuda.build.cache_info().currsize == 0  # nothing built\n"
        "assert _cuda.load.cache_info().currsize == 0\n"
        "from dxrvoxelizer_tpu_torch.utils import native\n"
        "assert native.build.cache_info().currsize == 0  # nor g++\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()  # no process group started\n"
        "print('ok', len(sys.modules))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        select_device()
    with pytest.raises(ValueError):
        select_device("tpu")


def test_warp_selects_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for flag in ("-warp", "/warp", "-cpu"):
        cfg = parse_args(["-mesh", "x.obj", flag])
        assert cfg.backend == "cpu"
        assert select_device(cfg.backend) == torch.device("cpu")
    assert parse_args(["-mesh", "x.obj"]).backend == "default"


def test_app_without_cuda_raises(monkeypatch):
    from dxrvoxelizer_tpu_torch.app.main import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["-mesh", "never_loaded.obj"])


def test_kernel_build_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _cuda.build.__wrapped__()


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


KERNELS = (voxelize_cuda.KERNEL, voxelize_queue_cuda.KERNEL, march_cuda.KERNEL,
           screen_warp_cuda.KERNEL, raystab_cuda.FOLD_EXTRACT, raystab_cuda.FOLD,
           raystab_mt_cuda.KERNEL)
# hand-written kernels for functions that are XLA code in the JAX package
XLA_KERNELS = (raymarch_fast.GATHER_MARCH, raymarch_fast.LIGHT_VOLUME)
ALL_KERNELS = KERNELS + XLA_KERNELS


def _gather_march_meta():
    raymarch_fast.gather_march(_meta(32, 32, 32), _meta(32, 32, 32),
                               np.eye(4, dtype=np.float32),
                               np.zeros(3, np.float32),
                               np.zeros(3, np.float32), 10, 10)


def _light_volume_meta(point: bool):
    vec = raymarch_fast.light_vector(np.array([1.0, 2.0, 3.0]),
                                     point_light=point)
    raymarch_fast.light_volume(_meta(32, 32, 32), vec, point_light=point)


def _meta_strips(s=2, p=300, bounds=True, by_id=False):
    """Meta strip tables; ``by_id``: a 40-row table read through ``p`` row
    ids (the refitted form)."""
    return raystab_cuda.StripTables(
        rays=_meta(s, 4, 128), cand_off=_meta(s, dtype=torch.int32),
        cand_cnt=_meta(s, dtype=torch.int32),
        rows=_meta(40 if by_id else p, 24),
        bounds=_meta(s, 2) if bounds else None,
        row_ids=_meta(p, dtype=torch.int32) if by_id else None)


def _meta_mt(s=2, v=300, p=40):
    i32 = torch.int32
    return raystab_mt_cuda.MTTables(
        pos=_meta(v, 3), dirs=_meta(v, 3), ray_ids=_meta(v, dtype=i32),
        ray_off=_meta(s, dtype=i32), ray_cnt=_meta(s, dtype=i32),
        cand_off=_meta(s, dtype=i32), cand_cnt=_meta(s, dtype=i32),
        rows=_meta(p, 12))


def _meta_map():
    """The reference-plane geometry resolve_screen reads from MarchInputs."""
    return SimpleNamespace(e_xy=(0.5, 0.5), c_ref=1.0, gmin=(0.0, 0.0),
                           gext=(1.0, 1.0))


@pytest.mark.parametrize("kernel", ["parity_voxelize", "parity_queue", "march",
                                    "resolve", "raystab_fold_extract",
                                    "raystab_fold_extract_by_id",
                                    "raystab_fold", "raystab_fold_by_id",
                                    "raystab_mt",
                                    "raystab_mt_shared", "gather_march",
                                    "light_volume", "light_volume_point"])
def test_wrapper_refuses_non_cpu_tensor_it_cannot_launch(kernel):
    """A tensor that is not on the CPU goes to the kernel or raises — the
    plain version is never a silent fallback for it."""
    launches = {k.name: k.launches for k in ALL_KERNELS}
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        if kernel == "gather_march":
            _gather_march_meta()
        elif kernel.startswith("light_volume"):
            _light_volume_meta(kernel.endswith("point"))
        elif kernel == "parity_voxelize":
            voxelize_cuda.voxelize_parity_tiles(_meta(1, 8, 16), 32)
        elif kernel == "parity_queue":
            voxelize_queue_cuda.voxelize_parity_queue_chunks(
                _meta(128 * 64, 16), _meta(128, dtype=torch.int32),
                _meta(128, dtype=torch.int32), 32)
        elif kernel.startswith("raystab_fold_extract"):
            raystab_cuda.fold_extract(
                _meta_strips(by_id=kernel.endswith("by_id")), 1000, 0.12)
        elif kernel.startswith("raystab_fold"):
            raystab_cuda.fold(_meta_strips(bounds=False,
                                           by_id=kernel.endswith("by_id")))
        elif kernel.startswith("raystab_mt"):
            # the overflow stream: strips of all rays against 320 rows
            raystab_mt_cuda.closest_hit(_meta_mt(s=3, p=320) if kernel.endswith(
                "shared") else _meta_mt())
        elif kernel == "march":
            v = _meta(32)
            march_cuda.march(_meta(2, 32, 32, 32), v, v, v, v, v, v,
                             _meta(16, 16), 1, ring=(4, 4, 8))
        else:
            screen_warp_cuda.resolve_screen(
                _meta(8, 8), _meta(8, 8), np.eye(4, dtype=np.float32),
                np.zeros(3, np.float32), np.zeros(3, np.float32), 3, 2, 2,
                False, True, _meta_map())
    after = {k.name: k.launches for k in ALL_KERNELS}
    assert after == launches


@pytest.mark.parametrize("bad", ["int64", "2-D", "float32"])
def test_fold_refuses_bad_row_ids(bad):
    """A strip stream's row ids are [P] int32: the fold's wrappers and plain
    versions refuse another dtype or shape before they read a row."""
    ids = {"int64": torch.zeros(3, dtype=torch.int64),
           "2-D": torch.zeros((3, 1), dtype=torch.int32),
           "float32": torch.zeros(3)}[bad]
    tb = raystab_cuda.StripTables(
        rays=torch.ones((1, 4, 128)), cand_off=torch.zeros(1, dtype=torch.int32),
        cand_cnt=torch.full((1,), 3, dtype=torch.int32),
        rows=torch.zeros((2, 24)), row_ids=ids)
    for fn in (raystab_cuda.fold, raystab_cuda.fold_plain,
               lambda x: raystab_cuda.fold_extract(x, 2, 0.12)):
        with pytest.raises(ValueError, match="row_ids: expected"):
            fn(tb)
    ok = dataclasses.replace(tb, row_ids=torch.tensor([1, 0, 1], dtype=torch.int32))
    assert raystab_cuda.fold_plain(ok)[0].shape == (1, 128)


@pytest.mark.parametrize("bad", ["past the end", "negative", "empty table"])
def test_fold_refuses_row_ids_outside_the_table(bad):
    """A row id must lie in [0, rows.shape[0]): the plain versions raise on
    one outside the table, and ids into an empty table are refused before
    any read (the kernel traps on such an id: tests/test_torch_cuda.py)."""
    rows, ids = {"past the end": (torch.zeros((2, 24)), [1, 2, 0]),
                 "negative": (torch.zeros((2, 24)), [1, -1, 0]),
                 "empty table": (torch.zeros((0, 24)), [0, 0, 0])}[bad]
    tb = raystab_cuda.StripTables(
        rays=torch.ones((1, 4, 128)), cand_off=torch.zeros(1, dtype=torch.int32),
        cand_cnt=torch.full((1,), 3, dtype=torch.int32), rows=rows,
        row_ids=torch.tensor(ids, dtype=torch.int32))
    err = ValueError if bad == "empty table" else IndexError
    for fn in (raystab_cuda.fold, raystab_cuda.fold_plain,
               lambda x: raystab_cuda.fold_extract(x, 2, 0.12),
               lambda x: raystab_cuda.fold_extract_plain(x, 2, 0.12)):
        with pytest.raises(err):
            fn(tb)


def test_gather_kernels_refuse_volumes_over_1024(monkeypatch):
    """The gather kernels index their volumes with 32-bit offsets: past the
    operand checks, a volume over 1024^3 raises before any launch."""
    monkeypatch.setattr(_cuda, "require", lambda *a, **k: None)
    big = _meta(1025, 1025, 1025)
    launches = {k.name: k.launches for k in ALL_KERNELS}
    with pytest.raises(ValueError, match="up to 1024"):
        raymarch_fast.light_volume(big, raymarch_fast.light_vector([1, 2, 3]))
    with pytest.raises(ValueError, match="up to 1024"):
        raymarch_fast.gather_march(big, big, np.eye(4, dtype=np.float32),
                                   np.zeros(3), np.zeros(3), 8, 8)
    assert {k.name: k.launches for k in ALL_KERNELS} == launches


def test_wrapper_on_a_box_without_cuda_raises_not_falls_back(monkeypatch):
    """Past the operand checks, a non-CPU request goes to the kernel
    library, whose build refuses without CUDA: the wrapper raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(_cuda, "require", lambda *a, **k: None)
    # bypass the process-wide caches (a card's tests may have filled them)
    monkeypatch.setattr(_cuda, "build", _cuda.build.__wrapped__)
    monkeypatch.setattr(_cuda, "load", _cuda.load.__wrapped__)
    before = {k.name: k.launches for k in ALL_KERNELS}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _gather_march_meta()
    for point in (False, True):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _light_volume_meta(point)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        voxelize_cuda.voxelize_parity_tiles(_meta(1, 8, 16), 32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        voxelize_queue_cuda.voxelize_parity_queue_chunks(
            _meta(128 * 64, 16), _meta(128, dtype=torch.int32),
            _meta(128, dtype=torch.int32), 32)
    for rule in ("backface", "hit"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            raystab_cuda.fold_extract(_meta_strips(), 1000, 0.12, rule)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        raystab_cuda.fold(_meta_strips())
    for tb in (_meta_mt(), _meta_mt(s=3, p=320)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            raystab_mt_cuda.closest_hit(tb)
    v = _meta(32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        march_cuda.march(_meta(2, 32, 32, 32), v, v, v, v, v, v,
                         _meta(16, 16), 1, ring=(4, 4, 8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        screen_warp_cuda.resolve_screen(
            _meta(8, 8), _meta(8, 8), np.eye(4, dtype=np.float32),
            np.zeros(3, np.float32), np.zeros(3, np.float32), 3, 2, 2, False,
            True, _meta_map(), coords=True)
    assert {k.name: k.launches for k in ALL_KERNELS} == before


def test_cuda_sources_present_with_notes():
    """Every kernel's source carries its note; ``replaces`` names the Pallas
    kernel's function (TPU kernels) or the XLA function (the others)."""
    for k in ALL_KERNELS:
        src = (REPO / k.source).read_text()
        assert "Replaces:" in src and "What bounds it on the card" in src
        assert "Design:" in src
        path, line = k.replaces.split(":")
        text = (REPO / path).read_text().splitlines()
        prefix = "def _" if k in KERNELS else "def "
        assert text[int(line) - 1].startswith(prefix), k.replaces
