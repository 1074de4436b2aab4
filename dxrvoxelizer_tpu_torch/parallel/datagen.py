"""Batch voxelization data generation (the Thingi10K throughput config).

Port of ``dxrvoxelizer_tpu/parallel/datagen.py``. BASELINE.json configures
"voxelize 1k-mesh Thingi10K subset at 128^3, throughput mode": a mesh list
solid-voxelized at 128^3 and saved as packed ``.npy`` words.

:func:`voxelize_batch` round-robins the meshes over a list of devices: each
mesh's buffers go to its device and its voxelize launches there
asynchronously (device i works on mesh i while the host parses mesh i+1);
each mesh leaves one occupancy-count tensor on its device, and the counts
are drained once at the end. Across hosts the work is embarrassingly
parallel: each process keeps its strided slice of the list
(:func:`shard_paths`, by its ``torch.distributed`` rank when a process group
is initialised) and needs no collective.

``impl``: "queue" (the work-queue kernel, 2.2), "pallas" (the binned parity
kernel, 2.1, on every tile with every triangle: ``voxelize_parity_bruteforce``),
"xla" (the counting oracle), or "auto" (queue on a GPU, the oracle on the
CPU). The JAX package pads the brute-force path's triangles to bucketed
counts to bound its recompiles; the CUDA kernel takes any count, so the
buckets are not carried over.

    python -m dxrvoxelizer_tpu_torch.parallel.datagen a.obj b.obj -grid 128
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from dxrvoxelizer_tpu_torch.ops.packing import pack_bits_z, unpack_bits_z
from dxrvoxelizer_tpu_torch.utils.objloader import load_obj

IMPLS = ("auto", "queue", "pallas", "xla")


@dataclass
class DatagenResult:
    path: str
    n: int
    occupied: int
    out_file: str | None
    device: str = ""


def shard_paths(paths: list, process_index: int | None = None,
                process_count: int | None = None) -> list:
    """This process's strided slice of the mesh list (multi-host datagen).

    Strided (``paths[i::count]``) rather than blocked, so heterogeneous mesh
    sizes spread evenly. The defaults read ``dist.get_rank()`` and
    ``dist.get_world_size()`` when a process group is initialised, else 0
    and 1 (the whole list)."""
    import torch.distributed as dist

    group = dist.is_available() and dist.is_initialized()
    pi = (dist.get_rank() if group else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if group else 1) if process_count is None else process_count
    return list(paths)[pi::pc]


def _voxelize(verts, tris, n: int, impl: str) -> torch.Tensor:
    from dxrvoxelizer_tpu_torch.ops.voxelize_cuda import (
        voxelize_parity_bruteforce,
    )
    from dxrvoxelizer_tpu_torch.ops.voxelize_queue import voxelize_parity_queue
    from dxrvoxelizer_tpu_torch.ops.voxelize_ref import voxelize_parity_ref

    if impl == "auto":
        impl = "queue" if verts.device.type == "cuda" else "xla"
    if impl == "queue":
        return voxelize_parity_queue(verts, tris, n)
    if impl == "pallas":
        return voxelize_parity_bruteforce(verts, tris, n)
    if impl == "xla":
        return pack_bits_z(voxelize_parity_ref(verts, tris, n=n))
    raise ValueError(f"unknown datagen impl {impl!r} (one of {IMPLS})")


def _dispatch_mesh(path, n: int, impl: str, device):
    """Load one OBJ and launch its voxelization on ``device`` -> (words,
    occupied) as device tensors; nothing here waits for the device."""
    mesh = load_obj(path)
    bound = mesh.bound()
    # the JAX package's float32 expression, on the host
    verts_h = np.asarray(
        (mesh.positions - bound[:3]) / max(float(bound[3]), 1e-20),
        dtype=np.float32)
    verts = torch.from_numpy(verts_h).to(device)
    tris = torch.from_numpy(mesh.triangles.astype(np.int64)).to(device)
    words = _voxelize(verts, tris, n, impl)
    return words, unpack_bits_z(words, n).sum()


def _save(words: torch.Tensor, path, n: int, out_dir) -> str | None:
    if out_dir is None:
        return None
    od = Path(out_dir)
    od.mkdir(parents=True, exist_ok=True)
    out_file = str(od / (Path(path).stem + f"_{n}.npy"))
    np.save(out_file, words.cpu().numpy())
    return out_file


def _default_devices() -> list[torch.device]:
    from dxrvoxelizer_tpu_torch.utils.device import select_device

    select_device()  # raises without CUDA: the CPU only when asked for
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def voxelize_mesh_file(path: str | Path, n: int = 128, impl: str = "auto",
                       out_dir: str | Path | None = None,
                       device=None) -> DatagenResult:
    """Load one OBJ, solid-voxelize it at n^3 on ``device`` (default the
    first card), optionally save the packed words as ``.npy``."""
    device = _default_devices()[0] if device is None else torch.device(device)
    words, occupied = _dispatch_mesh(path, n, impl, device)
    out_file = _save(words, path, n, out_dir)
    return DatagenResult(str(path), n, int(occupied), out_file,
                         device=str(device))


def voxelize_batch(paths: list[str | Path], n: int = 128, impl: str = "auto",
                   out_dir: str | Path | None = None,
                   devices: list | None = None) -> list[DatagenResult]:
    """Throughput mode over a mesh list, round-robin over ``devices``
    (default every card; pass ``["cpu"]`` for the CPU).

    Mesh i launches on ``devices[i % D]``, and every count drains in one
    copy per device at the end. For multi-host runs, slice the list with
    :func:`shard_paths` first."""
    devices = (_default_devices() if devices is None
               else [torch.device(d) for d in devices])
    pending = []  # (path, device, words, occupied): launched, not awaited
    for i, p in enumerate(paths):
        dev = devices[i % len(devices)]
        words, occupied = _dispatch_mesh(p, n, impl, dev)
        pending.append((p, dev, words, occupied))
    counts = {}
    for dev in devices:  # one drain per device
        idx = [i for i, q in enumerate(pending) if q[1] == dev]
        if idx:
            vals = torch.stack([pending[i][3] for i in idx]).cpu().tolist()
            counts.update(zip(idx, vals))
    return [DatagenResult(str(p), n, int(counts[i]),
                          _save(words, p, n, out_dir), device=str(dev))
            for i, (p, dev, words, _) in enumerate(pending)]


def main(argv=None) -> int:
    """CLI: ``python -m dxrvoxelizer_tpu_torch.parallel.datagen mesh1.obj
    ...``: voxelize a mesh list at ``-grid`` (128) and write packed ``.npy``
    grids to ``-out``, round-robin over the cards (``-devices D``: the first
    D; ``-warp``/``-cpu``: the CPU). Under a process group each process
    takes its :func:`shard_paths` slice."""
    import argparse
    import time

    ap = argparse.ArgumentParser(
        description="Batch solid voxelization of OBJ meshes into packed .npy")
    ap.add_argument("meshes", nargs="+", help="OBJ files to voxelize")
    ap.add_argument("-grid", type=int, default=128)
    ap.add_argument("-out", default="datagen_out")
    ap.add_argument("-impl", default="auto", choices=list(IMPLS))
    ap.add_argument("-devices", type=int, default=0,
                    help="use only the first D cards (0 = all)")
    ap.add_argument("-warp", "-cpu", dest="cpu", action="store_true",
                    help="run on the CPU")
    args = ap.parse_args(argv)

    devices = [torch.device("cpu")] if args.cpu else _default_devices()
    if args.devices > 0:
        devices = devices[: args.devices]
    meshes = shard_paths(args.meshes)
    t0 = time.perf_counter()
    results = voxelize_batch(meshes, n=args.grid, impl=args.impl,
                             out_dir=args.out, devices=devices)
    dt = time.perf_counter() - t0
    for r in results:
        print(f"{r.path}: {r.occupied} occupied -> {r.out_file} [{r.device}]")
    print(f"{len(results)} meshes at {args.grid}^3 on {len(devices)} "
          f"device(s) in {dt:.2f}s ({len(results) / max(dt, 1e-9):.2f} mesh/s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
