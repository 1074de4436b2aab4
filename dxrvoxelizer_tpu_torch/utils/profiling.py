"""Tracing / profiling.

Port of ``dxrvoxelizer_tpu/utils/profiling.py``. The reference ships PIX
hooks it never calls and shows only a 1 Hz FPS title
(DXRVoxelizer.cpp:553-584). Here: named per-pass scopes that land in
``torch.profiler`` traces (and as NVTX ranges on a CUDA device), a
wall-clock pass timer that fences the card, and a profiler trace of the
frame loop written as a Chrome trace (the PIX-capture analog).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


def _on_card(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


@contextlib.contextmanager
def pass_scope(name: str, device=None):
    """Annotate a pass for profiler traces (PIX BeginEvent/EndEvent analog):
    a ``record_function`` range, and an NVTX range when ``device`` is a
    CUDA device."""
    nvtx = _on_card(device)
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


class PassTimers:
    """Wall-clock pass timing with explicit device fencing.

    ``measure`` waits for the card (``torch.cuda.synchronize``) when
    ``device`` is a CUDA device, so use it for diagnostics: the production
    loop runs asynchronously and reads only the 1 Hz aggregate.
    """

    def __init__(self, device=None):
        self.device = device
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def measure(self, name: str):
        on_card = _on_card(self.device)
        if on_card:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        with pass_scope(name, self.device):
            yield
        if on_card:
            torch.cuda.synchronize(self.device)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def mean_ms(self, name: str) -> float:
        c = self.counts.get(name, 0)
        return (self.totals[name] / c * 1e3) if c else 0.0

    def summary(self) -> dict[str, float]:
        return {k: round(self.mean_ms(k), 3) for k in self.totals}

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the enclosed frames (host, and the card's kernels when CUDA
    is available) and write a Chrome trace into ``log_dir``
    (``trace_<pid>_<time>.json``; open it in Perfetto or chrome://tracing).
    Yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{time.strftime('%Y%m%d_%H%M%S')}.json")
    prof.export_chrome_trace(path)
