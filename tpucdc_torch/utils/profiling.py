"""Tracing and timing hooks, mirroring tpucdc/utils/profiling.py.

``profile_trace`` records a ``torch.profiler`` trace of a region (host and
card) into a Chrome trace file, behind the CLI's ``--profile DIR``;
``timed_block`` wall-times a region up to the end of its device work.
"""

from __future__ import annotations

import contextlib
import pathlib
import time

import torch


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """Profile the region into ``logdir/trace.json`` when ``logdir`` is set;
    nothing otherwise. The card's activity is recorded where there is one."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = pathlib.Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(path / "trace.json"))


@contextlib.contextmanager
def timed_block(sink: dict, key: str):
    """Wall-time a region into ``sink[key]`` (seconds), synchronizing the
    current CUDA device at exit so queued device work is counted; on a host
    without a card there is nothing to wait for."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        sink[key] = time.perf_counter() - t0
