"""Time two glue kernels, X.8 (the march's slab stack, ``csrc/grid.cu``
``grid_slabs_kernel``) and X.9 (the refit's per-triangle rows,
``csrc/refit_rows.cu`` ``refit_rows_kernel``), in turns with another
tree's on the card.

Run from the repository root:

    python3 scripts/glue_turns.py --parent TREE [--sizes 64,256]
                                  [--pairs 10] [--out FILE]

TREE's ``csrc/grid.cu`` and ``csrc/refit_rows.cu`` are built alone with
nvcc, in parallel (:func:`parent_kernels`, ``turns_common.build_alone``);
this tree's come from its own library. Cases:

- X.8 at each size (default 64^3, the cells' A, and 256^3, B's and C's) in
  all six (axis, flip): a seeded random density and light, contiguous, as
  the frames hand them over. The library call is the one PyTorch call that
  computes the stack, ``torch.stack`` of the slab-order views
  (``grid_cuda.slabs_plain``). Bound: 8 bytes a voxel read and 8 written.
- X.9 on cell B's 100,000-triangle torus and on the 327,680-triangle
  icosphere (level 7), with int64 and with int32 triangles (the refitters
  hand X.9 their int32 copy). Bound: the rows written, the triangles, the
  vertices and the normals read once. No PyTorch call computes it.

Every kernel of both trees is first held against its plain version bit
for bit (``torch.equal`` of the int32 views); a difference fails the run.
Then each case is timed in ``--pairs`` rounds, the side that goes first
rotating (``turns_common.rounds``): CUDA-event ms (``bench.cuda_ms``: 10 calls, median of 5) and
device us per call (``bench.device_us``, the profiler), this tree's kernel,
TREE's and, for X.8, the library call. A round is this tree's win over
TREE (or over the library) when its device us is the lower. Prints the
card's name and power limit; needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE / "scripts")]
import turns_common as tc  # noqa: E402

from dxrvoxelizer_tpu_torch import bench  # noqa: E402
from dxrvoxelizer_tpu_torch.ops import _cuda  # noqa: E402
from dxrvoxelizer_tpu_torch.ops import grid_cuda as gc  # noqa: E402
from dxrvoxelizer_tpu_torch.ops import raystab_fast as rsf  # noqa: E402
from dxrvoxelizer_tpu_torch.ops.warp import perm_for_axis  # noqa: E402

SIZES = (64, 256)
PAIRS = 10
SEED = 21
ICOSPHERE_LEVEL = 7  # 327,680 triangles: chip_smoke.py's 256^3 icosphere


def parent_kernels(tree: Path, workdir: Path):
    """TREE's grid.cu and refit_rows.cu, each built alone -> (slabs(density,
    light, axis, flip), rows(verts, tris, normals)) launching TREE's X.8 and
    X.9 (the C signatures are unchanged since they were added)."""
    libs = tc.build_alone(tree, ("grid", "refit_rows"), workdir)
    grid, rows_lib = libs["grid"], libs["refit_rows"]
    for lib, fn in ((grid, "dxv_grid_slabs"), (rows_lib, "dxv_refit_rows")):
        getattr(lib, fn).argtypes = list(_cuda._SIGNATURES[fn])
        getattr(lib, fn).restype = ctypes.c_int

    def slabs(density, light, axis: int, flip: bool):
        n = int(density.shape[0])
        out = torch.empty((2, n, n, n), dtype=torch.float32,
                          device=density.device)
        code = grid.dxv_grid_slabs(
            density.data_ptr(), *gc._slab_strides(density, axis),
            light.data_ptr(), *gc._slab_strides(light, axis), out.data_ptr(),
            n, int(flip), _cuda.stream_ptr(density.device))
        _cuda.check(code, "parent grid_slabs")
        return out

    def rows(verts, tris, normals):
        t_count = int(tris.shape[0])
        out = torch.empty((t_count + 1, 24), dtype=torch.float32,
                          device=verts.device)
        code = rows_lib.dxv_refit_rows(
            verts.data_ptr(), tris.data_ptr(), normals.data_ptr(),
            out.data_ptr(), t_count, int(verts.shape[0]),
            int(normals.shape[0]), int(tris.dtype == torch.int64),
            _cuda.stream_ptr(verts.device))
        _cuda.check(code, "parent refit_rows")
        return out

    return slabs, rows


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(torch.int32), b.view(torch.int32)))


def rows_meshes(meshes) -> dict:
    """The X.9 cases' meshes on the card: name -> (verts, normals, tris
    int64), the vertices in [-1, 1] and the normals their directions."""
    out = {}
    for name, (v, t) in (("B's torus", bench.torus_mesh()),
                         ("icosphere", meshes.icosphere_mesh(
                             ICOSPHERE_LEVEL)[::2])):
        v = np.asarray(v, np.float32)
        v = v / np.abs(v).max()
        nr = v / np.linalg.norm(v, axis=-1, keepdims=True)
        out[f"{name} ({len(t):,} triangles)"] = (
            torch.from_numpy(v).cuda(),
            torch.from_numpy(nr.astype(np.float32)).cuda(),
            torch.from_numpy(np.asarray(t, np.int64)).cuda())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--pairs", type=int, default=PAIRS)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("glue_turns: needs a CUDA card", file=sys.stderr)
        return 2
    card = bench.card_line()
    info = _cuda.build()
    print(f"kernels built in {info.seconds:.1f} s; {card}", flush=True)
    lines = info.log.splitlines()  # ptxas on X.8 and X.9
    print("\n".join(" ".join(lines[i:i + 4]) for i, line in enumerate(lines)
                    if "Compiling entry" in line and ("grid_slabs" in line
                                                      or "refit_rows" in line)),
          flush=True)
    p_slabs, p_rows = parent_kernels(
        args.parent.resolve(), Path(tempfile.mkdtemp(prefix="dxv_parent_")))
    ok, rows = True, []
    for n in (int(s) for s in args.sizes.split(",")):
        gen = torch.Generator(device="cuda").manual_seed(SEED + n)
        dens = torch.rand((n, n, n), generator=gen, device="cuda")
        light = torch.rand((n, n, n), generator=gen, device="cuda")
        bound_ms = 16 * n ** 3 / tc.HBM * 1e3
        for axis in range(3):
            for flip in (False, True):
                want = gc.slabs_plain(dens, light, axis, flip)
                held = {who: bits_equal(f(dens, light, axis, flip), want)
                        for who, f in (("change", gc.slabs),
                                       ("parent", p_slabs))}
                ok &= all(held.values())
                perm = perm_for_axis(axis)
                views = [gc.to_slab_order(v, perm, flip)
                         for v in (dens, light)]
                res = tc.rounds({
                    "parent": lambda a=axis, f=flip: p_slabs(dens, light, a, f),
                    "change": lambda a=axis, f=flip: gc.slabs(dens, light, a, f),
                    "library": lambda v=views: torch.stack(v).contiguous(),
                }, bound_ms, args.pairs)
                print(f"X.8 {n}^3 axis {axis} flip {int(flip)} (bit for bit "
                      f"{held}; bound {bound_ms:.6f} ms, bytes): "
                      f"{res['line']}; {card}", flush=True)
                rows.append({"kernel": "X.8", "n": n, "axis": axis,
                             "flip": flip, "held": held, "bound_ms": bound_ms,
                             "wins": res["wins"], "measured": res["measured"],
                             "runs": res["runs"]})
        del dens, light
        torch.cuda.empty_cache()
    meshes = tc.by_path("dxv_test_meshes", HERE / "tests" / "meshes.py")
    for name, (v, nr, t64) in rows_meshes(meshes).items():
        want = rsf._fused_coef_matrix(v, t64, nr)
        for tris in (t64, t64.to(torch.int32)):
            width = str(tris.dtype)[6:]
            held = {who: bits_equal(f(v, tris, nr), want)
                    for who, f in (("change", rsf.fused_coef_matrix),
                                   ("parent", p_rows))}
            ok &= all(held.values())
            t_count = int(tris.shape[0])
            bound_ms = ((t_count + 1) * 96 + tris.numel() * tris.element_size()
                        + v.numel() * 4 + nr.numel() * 4) / tc.HBM * 1e3
            res = tc.rounds({
                "parent": lambda a=(v, tris, nr): p_rows(*a),
                "change": lambda a=(v, tris, nr): rsf.fused_coef_matrix(*a),
            }, bound_ms, args.pairs)
            print(f"X.9 {name}, {width} triangles (bit for bit {held}; "
                  f"bound {bound_ms:.6f} ms, bytes): {res['line']}; {card}",
                  flush=True)
            rows.append({"kernel": "X.9", "mesh": name, "width": width,
                         "held": held, "bound_ms": bound_ms,
                         "wins": res["wins"], "measured": res["measured"],
                         "runs": res["runs"]})
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "rows": rows}))
    print(f"every kernel of both trees bit for bit its plain version: {ok}; "
          f"{card}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
