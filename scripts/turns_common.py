"""Shared machinery of the scripts that time this tree's kernels in turns
with another tree's on the card (``glue_turns.py``,
``light_sweep_turns.py``) and of the scripts that load the repository's
test helpers (``frames.py``, ``static_fold_turns.py``): modules loaded by
path, TREE's CUDA sources built alone, and rounds of timings in which the
side that goes first rotates.

Import it with the ``scripts`` directory on ``sys.path``; the functions
that build or time import the port, so the caller puts the tree whose
port it times on ``sys.path`` first. Imports no JAX.
"""

from __future__ import annotations

import ctypes
import importlib.util
import statistics
import subprocess
import sys
from pathlib import Path

HBM = 3.35e12  # bytes per second, the H100 SXM's published rate


def by_path(name: str, path: Path):
    """A module by path: an installed package named ``tests`` would shadow
    the repository's directory of that name. Registered in ``sys.modules``
    before it runs (its dataclasses look their module up there)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def build_alone(tree: Path, names, workdir: Path) -> dict:
    """TREE's ``csrc/<name>.cu`` for each of ``names``, each built alone
    with nvcc (this tree's flags), all at once -> name -> ``ctypes.CDLL``.
    Prints ptxas's register and spill lines; a failed build raises."""
    from dxrvoxelizer_tpu_torch.ops import _cuda

    csrc = tree / "dxrvoxelizer_tpu_torch" / "csrc"
    libs = {name: workdir / f"libparent_{name}.so" for name in names}
    procs = {name: subprocess.Popen(
        [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(lib),
         str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, lib in libs.items()}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on TREE's {name}.cu:\n{log}")
        print(f"the parent's {name}.cu built: " + " ".join(
            line.strip() for line in log.splitlines()
            if "registers" in line or "spill" in line), flush=True)
    return {name: ctypes.CDLL(str(lib)) for name, lib in libs.items()}


def timed(fn) -> dict:
    """CUDA-event ms (``bench.cuda_ms``: 10 calls, median of 5) and device
    us per call (``bench.device_us``, the profiler; 0 when it saw none)."""
    from dxrvoxelizer_tpu_torch import bench

    return {"ms": bench.cuda_ms(fn),
            "dev_us": bench.device_us(fn) or bench.device_us(fn)}


def rounds(sides: dict, bound_ms: float, pairs: int,
           n_steps: int | None = None) -> dict:
    """``pairs`` rounds of :func:`timed` over ``sides`` (name -> fn, one of
    them "change", this tree's), the side that goes first rotating (with
    two sides: alternating) -> each side's runs, the rounds in which the
    change's device us was below each other side's (a round with a side
    not measured counts for neither), and the summary line: each side's ms
    and device us (range, median, interquartile range, us a step of
    ``n_steps`` when given, the share of ``bound_ms``)."""
    names = list(sides)
    runs = {k: [] for k in names}
    wins = {k: 0 for k in names if k != "change"}
    measured = dict(wins)
    for i in range(pairs):
        got = {}
        for k in names[i % len(names):] + names[:i % len(names)]:
            got[k] = timed(sides[k])
            runs[k].append(got[k])
        for k in wins:
            if got[k]["dev_us"] and got["change"]["dev_us"]:
                measured[k] += 1
                wins[k] += got["change"]["dev_us"] < got[k]["dev_us"]

    def side(k):
        us = [t["dev_us"] for t in runs[k] if t["dev_us"]]
        ms = [t["ms"] for t in runs[k]]
        if not us:
            return f"{k} ms {min(ms):.4f}-{max(ms):.4f}; device us not measured"
        med = statistics.median(us)
        q1, _, q3 = (statistics.quantiles(us, n=4) if len(us) > 1
                     else (us[0],) * 3)
        step = f", {med / n_steps:.3f} a step" if n_steps else ""
        return (f"{k} ms {min(ms):.4f}-{max(ms):.4f} (median "
                f"{statistics.median(ms):.4f}), device us {min(us):.2f}-"
                f"{max(us):.2f} (median {med:.2f}, interquartile range "
                f"{q3 - q1:.2f}{step}, share {bound_ms / (med / 1e3):.4f})")

    line = (f"{pairs} rounds, the first side rotating: "
            + "; ".join(side(k) for k in names) + "; the change faster "
            + ", ".join(f"than {k} in {wins[k]} of {measured[k]}"
                        for k in wins))
    return {"runs": runs, "wins": wins, "measured": measured, "line": line}
