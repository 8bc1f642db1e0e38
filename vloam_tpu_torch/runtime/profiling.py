"""Timing and observability utilities (port of
vloam_tpu/runtime/profiling.py).

The reference's TicToc stopwatch (tic_toc.h:10-32), the verbose-level gated
frame-budget watchdog (>100 ms, lidar_odometry_mapping.cpp:150-153) and a
per-stage timing summary, copied; a device fence that synchronizes the card,
and a torch.profiler trace context that writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import logging
import time
from pathlib import Path

import torch

log = logging.getLogger("vloam_tpu_torch")


class TicToc:
    def __init__(self):
        self.tic()

    def tic(self):
        self.t0 = time.perf_counter()

    def toc_ms(self) -> float:
        return (time.perf_counter() - self.t0) * 1000.0


class Watchdog:
    """Frame-budget monitor: warns when a frame exceeds the budget."""

    def __init__(self, budget_ms: float = 100.0, verbose: bool = False):
        self.budget_ms = budget_ms
        self.verbose = verbose
        self.overruns = 0
        self.frames = 0

    def check(self, elapsed_ms: float) -> bool:
        self.frames += 1
        over = elapsed_ms > self.budget_ms
        if over:
            self.overruns += 1
            if self.verbose:
                log.warning("frame took %.1f ms (budget %.0f ms)",
                            elapsed_ms, self.budget_ms)
        return over


def _devices(tree):
    if isinstance(tree, torch.Tensor):
        yield tree.device
    elif isinstance(tree, (tuple, list)):
        for sub in tree:
            yield from _devices(sub)


def fence(tree=None) -> None:
    """Block until the card has run everything queued so far: a fresh
    torch.cuda.synchronize() of each CUDA device holding a leaf of `tree`
    (of the current device when `tree` is None). CPU work is synchronous;
    then there is nothing to wait for."""
    if tree is None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return
    for dev in {d for d in _devices(tree) if d.type == "cuda"}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def device_trace(out_dir: str):
    """torch.profiler trace of the enclosed work (CPU, and the card where
    there is one), written to out_dir/trace.json (Chrome trace format:
    chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        fence()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(str(Path(out_dir) / "trace.json"))


def summarize_timings(stats: list[dict]) -> dict:
    """Mean per-stage ms over a run (skipping warmup frame 0/1 compiles)."""
    if not stats:
        return {}
    keys = set().union(*stats)
    body = stats[2:] if len(stats) > 4 else stats
    out = {}
    for k in sorted(keys):
        vals = [s[k] for s in body if k in s]
        if vals:
            out[k] = sum(vals) / len(vals)
    return out
