"""Time the light recurrences' kernel (``csrc/light_sweep.cu``: X.3, the
``-hq`` reference step, X.4, the ``-fast`` per-slab sweep, and X.5, the
``-pointlight`` perspective sweep) in turns with another tree's on the
card.

Run from the repository root:

    python3 scripts/light_sweep_turns.py --parent TREE [--sizes 64,256]
                                         [--sweeps X.3,X.4,X.5]
                                         [--pairs 10] [--out FILE]

TREE's ``csrc/light_sweep.cu`` alone is built with nvcc
(:func:`parent_sweep`, ``turns_common.build_alone``). At each size
(default 32, 64, 128, 160 and 256): a
seeded random density (a fifth of the voxels filled, fractional alphas)
and the cells' light (``tests/torch_cases.cell_light``: d0 = 3 at 64^3, 12
at 256^3, marching along the layout's minor axis; X.5: the app's default
light_pt as a point on the cells' axis and side,
``tests/torch_cases.point_light(2, -1.0, "far", n)``). Each instance of
both trees is held against its plain version (above 1e-5 fails), then
timed in ``--pairs`` pairs, the side that goes first alternating
(:func:`pairs_in_turns`): CUDA-event ms (``bench.cuda_ms``: 10 calls,
median of 5), device us per call (``bench.device_us``, the profiler), us
per step (X.3 ceil(n/d0) steps, X.4 and X.5 n) and the roofline share
against the density read and the field written once (8 bytes a voxel at
3.35 TB/s). Where TREE has no X.5, this tree's X.5 is timed alone.
A pair is this tree's win when its device us is the lower. Prints the
card's name and power limit; needs a CUDA card; imports no JAX.
``chip_smoke.py --parent TREE`` (phase 22b) runs the same pairs at the
64^3 and 256^3 frames' inputs.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
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
from dxrvoxelizer_tpu_torch.ops import raymarch_warp as rw  # noqa: E402

TOL = 1e-5  # the port's bar against its plain versions (chip_smoke.py)
SIZES = (32, 64, 128, 160, 256)
PAIRS = 10
SEED = 16


def density(n: int, seed: int = SEED) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed + n)
    fill = torch.rand((n, n, n), generator=gen) < 0.2
    return (fill * torch.rand((n, n, n), generator=gen)).cuda()


def point_call(dens, light, n: int, **kw):
    """X.5 on the point light ``light``."""
    lt = np.asarray(light, np.float32)
    axis, flip, _ = rw.point_light_statics(lt, n)
    return rw.light_sweep_point(dens, lt, n, axis, flip, **kw)


def statics(ref: bool, light, n: int) -> tuple:
    """(axis, flip, d0) of the light at n (d0 1 for X.4)."""
    lt = np.asarray(light, np.float32)
    if ref:
        return rw.light_ref_statics(lt, n)
    return (*rw.light_statics(lt), 1)


def call(ref: bool, dens, light, n: int, **kw):
    lt = np.asarray(light, np.float32)
    axis, flip, d0 = statics(ref, light, n)
    if ref:
        return rw.light_sweep_ref(dens, lt, n, axis, flip, d0, **kw)
    return rw.light_sweep(dens, lt, n, axis, flip, **kw)


def parent_sweep(tree: Path, workdir: Path):
    """TREE's csrc/light_sweep.cu built alone -> call(ref, dens, light, n)
    launching its kernel with this tree's statics (the C signature with or
    without the scratch word, whichever TREE has); ``call.point(dens,
    light, n)`` launches TREE's X.5 (None where TREE has none)."""
    src = tree / "dxrvoxelizer_tpu_torch" / "csrc" / "light_sweep.cu"
    lib = tc.build_alone(tree, ("light_sweep",), workdir)["light_sweep"]
    with_scratch = "void* scratch" in src.read_text()
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.dxv_light_sweep.argtypes = ([P, P] + ([P] if with_scratch else [])
                                    + [I] * 5 + [F] * 4 + [I] * 5 + [P])
    lib.dxv_light_sweep.restype = I
    # its own scratch, as this tree's wrapper keeps one per stream
    scratch = torch.zeros(rw.SCRATCH_WORDS, dtype=torch.int32,
                          device="cuda")

    def run(ref: bool, dens, light, n: int):
        lt = np.asarray(light, np.float32)
        axis, flip, d0 = statics(ref, light, n)
        key = rw._light_key(lt)
        if ref:
            st = rw.ref_statics(key, n, axis, flip, d0)
            w, shift, absl, box = st.w, st.shift, st.absl, st.box
        else:
            sx, sy, absl = rw._dir_statics(key, n, axis, flip)
            w, shift, box = 0.0, (sx, sy), (0, n - 1, 0, n - 1, n - 1)
        out = torch.empty_like(dens)
        head = [dens.data_ptr(), out.data_ptr()]
        if with_scratch:
            head.append(scratch.data_ptr())
        code = lib.dxv_light_sweep(
            *head, n, int(ref), axis, int(flip), d0, w, *shift, absl, *box,
            _cuda.stream_ptr(dens.device))
        _cuda.check(code, "parent light_sweep")
        return out

    run.point = None
    if "dxv_light_sweep_point" in src.read_text():
        lib.dxv_light_sweep_point.argtypes = [P, P, P, I, I, I, F, F, F, F, P]
        lib.dxv_light_sweep_point.restype = I

        def point(dens, light, n: int):
            lt = np.asarray(light, np.float32)
            axis, flip, _ = rw.point_light_statics(lt, n)
            out = torch.empty_like(dens)
            code = lib.dxv_light_sweep_point(
                dens.data_ptr(), out.data_ptr(), scratch.data_ptr(), n, axis,
                int(flip), *rw._point_statics(rw._light_key(lt), axis, flip),
                rw.ABSORPTION, _cuda.stream_ptr(dens.device))
            _cuda.check(code, "parent light_sweep_point")
            return out

        run.point = point
    return run


def text(t: dict, bound_ms: float, n_steps: int) -> str:
    if not t["dev_us"]:
        return f"{t['ms']:.4f} ms; device us not measured"
    return (f"{t['ms']:.4f} ms, {t['dev_us']:.2f} us device, "
            f"{t['dev_us'] / n_steps:.3f} us a step, share "
            f"{bound_ms / (t['dev_us'] / 1e3):.4f}")


def pairs_in_turns(parent, change, bound_ms: float, n_steps: int,
                   pairs: int = PAIRS) -> dict:
    """``pairs`` pairs of timings, the parent first in even pairs and the
    change first in odd ones (``turns_common.rounds``) -> each side's runs,
    the pairs the change won (lower device us; a pair with a side not
    measured counts for neither), and the summary line."""
    res = tc.rounds({"parent": parent, "change": change}, bound_ms, pairs,
                    n_steps)
    return {**res, "wins": res["wins"]["parent"],
            "measured": res["measured"]["parent"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--sizes", default=",".join(map(str, SIZES)))
    ap.add_argument("--sweeps", default="X.3,X.4,X.5",
                    help="the instances to time")
    ap.add_argument("--pairs", type=int, default=PAIRS)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("light_sweep_turns: needs a CUDA card", file=sys.stderr)
        return 2
    card = bench.card_line()
    info = _cuda.build()
    print(f"kernels built in {info.seconds:.1f} s; {card}", flush=True)
    # ptxas on the sweep's instances: registers, shared memory, spills
    lines = info.log.splitlines()
    print("\n".join(" ".join(lines[i:i + 4]) for i, line in
                    enumerate(lines) if "Compiling entry" in line
                    and "light_sweep" in line), flush=True)
    cases = tc.by_path("dxv_test_torch_cases",
                       HERE / "tests" / "torch_cases.py")
    light = cases.cell_light("dragon-64-hq")
    parent = parent_sweep(args.parent.resolve(),
                          Path(tempfile.mkdtemp(prefix="dxv_parent_")))
    worst, rows = 0.0, []
    for n in (int(s) for s in args.sizes.split(",")):
        dens = density(n)
        for ref in (True, False):
            name = "X.3" if ref else "X.4"
            if name not in args.sweeps.split(","):
                continue
            axis, flip, d0 = statics(ref, light, n)
            n_steps = -(-n // d0) if ref else n
            bound_ms = n ** 3 * 8 / tc.HBM * 1e3
            want = call(ref, dens, light, n, use_kernel=False)
            errs = {who: float((f() - want).abs().max()) for who, f in (
                ("change", lambda: call(ref, dens, light, n)),
                ("parent", lambda: parent(ref, dens, light, n)))}
            worst = max(worst, *errs.values())
            res = pairs_in_turns(lambda: parent(ref, dens, light, n),
                                 lambda: call(ref, dens, light, n),
                                 bound_ms, n_steps, args.pairs)
            print(f"{name} {n}^3 (axis {axis}, flip {int(flip)}, d0 {d0}, "
                  f"{n_steps} steps; max|err| change {errs['change']:.3g}, "
                  f"parent {errs['parent']:.3g}), the kernel of "
                  f"{args.parent} in turns with this tree's: {res['line']}; "
                  f"{card}", flush=True)
            rows.append({"n": n, "sweep": name, "d0": d0, "errs": errs,
                         "wins": res["wins"], "measured": res["measured"],
                         "runs": res["runs"]})
        # X.5: TREE's in turns with this tree's, or this tree's alone
        if "X.5" not in args.sweeps.split(","):
            continue
        pl = cases.point_light(2, -1.0, "far", n)
        axis, flip, _ = rw.point_light_statics(np.asarray(pl, np.float32), n)
        bound_ms = n ** 3 * 8 / tc.HBM * 1e3
        want = point_call(dens, pl, n, use_kernel=False)
        sides = {"change": lambda: point_call(dens, pl, n)}
        if parent.point is not None:
            sides["parent"] = lambda: parent.point(dens, pl, n)
        errs = {who: float((f() - want).abs().max())
                for who, f in sides.items()}
        worst = max(worst, *errs.values())
        if parent.point is None:
            res = {"line": f"no parent kernel ({args.parent} has no X.5); "
                           f"this tree's " + text(tc.timed(sides["change"]),
                                                  bound_ms, n),
                   "wins": 0, "measured": 0, "runs": {}}
        else:
            res = pairs_in_turns(sides["parent"], sides["change"], bound_ms,
                                 n, args.pairs)
        print(f"X.5 {n}^3 (axis {axis}, flip {int(flip)}, light {pl}, {n} "
              f"steps; max|err| " + ", ".join(
                  f"{k} {v:.3g}" for k, v in errs.items())
              + f"): {res['line']}; {card}", flush=True)
        rows.append({"n": n, "sweep": "X.5", "d0": 1, "errs": errs,
                     "wins": res["wins"], "measured": res["measured"],
                     "runs": res["runs"]})
        del dens
        torch.cuda.empty_cache()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "rows": rows}))
    print(f"largest error against the plain versions {worst:.3g}; {card}")
    return 0 if worst <= TOL and math.isfinite(worst) else 1


if __name__ == "__main__":
    sys.exit(main())
