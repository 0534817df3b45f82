"""The traced slice of a window: ``torch.profiler`` over a few requests, read
into device intervals (kernels, copies and sets), busy and idle time, and the
host activity behind each idle gap.

Busy time is the union of the device intervals, so overlapping work on
several streams counts once; the idle share is the traced time with nothing
on the device. Each idle gap is put down to the innermost host operation or
span that was open at its midpoint.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

# The benchmark's spans are recorded as "cdcbench.<name>"; the profiler
# also lays each one on the device's timeline as an annotation, which is no
# device work and is left out of it.
SPAN_PREFIX = "cdcbench."


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_us: float
    end_us: float


@dataclasses.dataclass
class TraceView:
    """What a per-layer metric reads. ``spans`` holds, per span name, the
    host seconds of its calls in the requests outside the traced slice (one
    call a request);
    ``per_request`` the host seconds of every request outside the traced
    slice; ``ops`` the device intervals of the slice, which held
    ``requests`` requests; ``counts`` the benchmark's own FLOP and byte
    counts for one request of this cell."""
    ops: list
    window_s: float
    busy_s: float
    requests: int
    spans: dict
    per_request: list
    counts: dict
    workload: str
    breakdown: dict
    chips: int = 1

    def device_seconds(self, pattern: str) -> float:
        """Device seconds of the slice's operations whose name holds
        ``pattern``."""
        return sum(o.end_us - o.start_us for o in self.ops
                   if pattern in o.name) / 1e6


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def read_profile(prof) -> dict:
    """Device ops, busy and window seconds, and the breakdown of a finished
    ``torch.profiler.profile``."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    ops, host = [], []
    # The profiler's raw events: building its FunctionEvent tree would take
    # a minute for a training chunk.
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns() / 1e3, e.duration_ns() / 1e3
        if e.device_type() == cuda:
            if e.is_user_annotation() or e.name().startswith(SPAN_PREFIX):
                continue
            if d > 0:
                ops.append(DeviceOp(e.name(), s, s + d))
        else:
            host.append((s, s + d, e.name()))
    if not ops:
        return {"ops": [], "busy_s": 0.0, "window_s": 0.0,
                "breakdown": {"device_ops": [], "idle_gaps": []}}
    lo = min(o.start_us for o in ops)
    hi = max(o.end_us for o in ops)
    busy = _union([(o.start_us, o.end_us) for o in ops])
    busy_us = sum(e - s for s, e in busy)
    by_name = collections.Counter()
    for o in ops:
        by_name[o.name] += (o.end_us - o.start_us) / 1e6
    gaps = []
    edges = [lo] + [x for se in busy for x in se] + [hi]
    for k in range(0, len(edges) - 1, 2):
        if edges[k + 1] > edges[k]:
            gaps.append((edges[k], edges[k + 1]))
    idle = _gap_owners(gaps, host)
    return {
        "ops": ops,
        "busy_s": busy_us / 1e6,
        "window_s": (hi - lo) / 1e6,
        "breakdown": {
            "device_ops": [[n, s] for n, s in by_name.most_common(10)],
            "idle_gaps": [[n, s] for n, s in idle.most_common(10)],
        },
    }


def _gap_owners(gaps, host) -> collections.Counter:
    """Idle seconds by the innermost host event open at each gap's
    midpoint; "host (no traced op)" where none is."""
    host.sort()
    starts = [h[0] for h in host]
    owners = collections.Counter()
    for s, e in gaps:
        mid = 0.5 * (s + e)
        k = bisect.bisect_right(starts, mid) - 1
        name = "host (no traced op)"
        for j in range(k, max(k - 400, -1), -1):
            if host[j][1] > mid:
                name = host[j][2]
                break
        owners[name] += (e - s) / 1e6
    return owners

