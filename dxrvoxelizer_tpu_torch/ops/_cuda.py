"""Build, load and describe the port's hand-written CUDA kernels.

The sources live in ``dxrvoxelizer_tpu_torch/csrc/*.cu``, each with a plain C
entry point. At first use each source is compiled by its own ``nvcc`` process
for Hopper (``sm_90a``), all started together, and the objects are linked
into one shared library, keyed by a hash of the sources and flags, in
``dxrvoxelizer_tpu_torch/_build/`` (listed in ``.gitignore``), and loaded with
``ctypes``. Nothing here runs at import time: the CPU-only test machines
import every module but never build.

Every C entry point takes raw device pointers and the CUDA stream as
``void*`` (the screen resolve, called once per frame on the host's critical
path, takes them packed with its constants in one host buffer), launches on
that stream, and returns ``cudaGetLastError()``; :func:`check` turns a
non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures of the entry points (pointers and the stream as void*)
_SIGNATURES = {
    # coef, spans, counts, words, n_tiles, k, n, stream
    "dxv_parity_voxelize": (_P, _P, _P, _P, _I, _I, _I, _P),
    # the same, then layout, splits, threads, stream
    "dxv_parity_voxelize_variant": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                    _P),
    # coefs, spans, chunk_tile, chunk_nsub, words, num_chunks, n, k_chunk,
    # stream
    "dxv_parity_queue": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # the same, then run, threads, stream
    "dxv_parity_queue_variant": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # coefs, spans, chunk_tile, chunk_nsub, group, tile_lo, tiles,
    # num_chunks, n, k_chunk, stream
    "dxv_parity_queue_group": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # slabs, wts, front, scale_x, off_x, scale_y, off_y, delta,
    # transmit, scatter, kn, n, m, ss, cz, fx, fy4, stream
    "dxv_march": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                  _I, _I, _P),
    # one host buffer: the pointers, the stream and the per-frame constants
    "dxv_resolve_screen": (ctypes.c_char_p,),
    # rays, cand_off, cand_cnt, rows, row_ids, n_rows, bounds, n_bounds, t,
    # id, ns, strips, t_count, threshold, rule_hit, stream
    "dxv_raystab_fold_extract": (_P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _P,
                                 _I, _I, _F, _I, _P),
    # the same, then groups, stages, defer, stream
    "dxv_raystab_fold_extract_variant": (_P, _P, _P, _P, _P, _I, _P, _I, _P,
                                         _P, _P, _I, _I, _F, _I, _I, _I, _I,
                                         _P),
    # rays, cand_off, cand_cnt, rows, row_ids, n_rows, bounds, n_bounds, t,
    # id, strips, stream
    "dxv_raystab_fold": (_P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _P),
    # pos, dirs, ray_ids, ray_off, ray_cnt, cand_off, cand_cnt, rows, t, id,
    # slices, lanes, stream
    "dxv_raystab_mt": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    # the same, then threads, defer, stage, stream
    "dxv_raystab_mt_variant": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _I, _P),
    # density, light, rgb, camera (host floats), n, width, height,
    # n_samples, stream
    "dxv_gather_march": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # density, out, n, n_light, lss, step or light point x, y, z, point,
    # stream
    "dxv_light_volume": (_P, _P, _I, _I, _F, _F, _F, _F, _I, _P),
    # density, out, scratch, n, ref, axis, flip, d0, w, shift x, shift y,
    # absl, xlo, xhi, ylo, yhi, kmax, stream
    "dxv_light_sweep": (_P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _I,
                        _I, _I, _I, _I, _P),
    # density, out, scratch, n, axis, flip, light x, y, z, absorption,
    # stream
    "dxv_light_sweep_point": (_P, _P, _P, _I, _I, _I, _F, _F, _F, _F, _P),
    # src, slots, gate, rgba, density, words, n, quantize, stream
    "dxv_grid_untile": (_P, _P, _P, _P, _P, _P, _I, _I, _P),
    # words, density, n, stream
    "dxv_grid_unpack": (_P, _P, _I, _P),
    # density and its strides (slab x, y, marching axis), light and its
    # strides, out, n, flip, stream
    "dxv_grid_slabs": (_P, _L, _L, _L, _P, _L, _L, _L, _P, _I, _I, _P),
    # ray_slot, main t, id, ns, t/id stride, ns stride, the near-origin
    # stream's the same, gate, rgba, density, words, n, quantize, stream
    "dxv_grid_merge": (_P, _P, _P, _P, _L, _L, _P, _P, _P, _L, _L, _P, _P,
                       _P, _P, _I, _I, _P),
    # verts, tris, normals, out, t_count, n_verts, n_normals, tris64, stream
    "dxv_refit_rows": (_P, _P, _P, _P, _I, _L, _L, _I, _P),
}


@dataclass
class Kernel:
    """A hand-written kernel: where it lives, what it replaces, and how many
    times its wrapper launched it (reset by callers that count a run)."""

    name: str
    symbol: str  # the __global__ function (a prefix of its profiler name)
    source: str  # repository-relative path of the .cu file
    replaces: str  # file:line of the Pallas TPU kernel it ports
    route: str = "cuda"
    launches: int = 0


def all_kernels() -> list[Kernel]:
    """Every hand-written kernel of the port (imported here, on call: the
    modules that hold them import this one)."""
    from dxrvoxelizer_tpu_torch.ops import (
        grid_cuda,
        march_cuda,
        raymarch_fast,
        raymarch_warp,
        raystab_cuda,
        raystab_fast,
        raystab_mt_cuda,
        screen_warp_cuda,
        voxelize_cuda,
        voxelize_queue_cuda,
    )

    return [voxelize_cuda.KERNEL, voxelize_queue_cuda.KERNEL,
            march_cuda.KERNEL, screen_warp_cuda.KERNEL,
            raystab_cuda.FOLD_EXTRACT, raystab_cuda.FOLD,
            raystab_mt_cuda.KERNEL, raymarch_fast.GATHER_MARCH,
            raymarch_fast.LIGHT_VOLUME, raymarch_warp.LIGHT_SWEEP_REF,
            raymarch_warp.LIGHT_SWEEP, raymarch_warp.LIGHT_SWEEP_POINT,
            grid_cuda.UNTILE, grid_cuda.UNPACK, grid_cuda.SLABS,
            raystab_fast.REFIT_ROWS, grid_cuda.MERGE]


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA toolkit is required")
    return found


@dataclass
class BuildInfo:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output (ptxas register/shared-memory report)


@functools.cache
def build() -> BuildInfo:
    """Compile ``csrc/*.cu`` into one library unless it is already built."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the CUDA kernels cannot run")
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in [*srcs, *sorted(CSRC_DIR.glob("*.cuh"))]:  # sources and headers
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_DIR / f"libdxv_kernels_{h.hexdigest()[:16]}.so"
    if out.is_file():
        return BuildInfo(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # one nvcc per source, all at once, then one link; build under temporary
    # names and rename: concurrent builds never load a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [Path(tmpdir) / f"{s.stem}.o" for s in srcs]
        procs = [
            subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for s, o in zip(srcs, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        log = "\n".join(logs)
        failed = [s.name for s, p in zip(srcs, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp = Path(tmpdir) / out.name
        res = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
            )
        os.replace(tmp, out)
    return BuildInfo(out, time.perf_counter() - t0, log)


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with every signature set."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(code: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}")


def stream_ptr(device: torch.device) -> int:
    """The device's current CUDA stream as an integer (the raw handle, with
    no Stream object built on the way: the wrappers call this per launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple[int, ...] | None = None,
            contiguous: bool = True) -> None:
    """Validate a kernel operand: CUDA, dtype, shape, contiguity (unless the
    kernel reads it through its strides)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
