"""The arithmetic the per-layer metric files share. Each takes a
``tracing.TraceView`` and returns a number, or None where the run gave it
nothing to read (a span the port no longer has, a kernel that did not run):
the harness then leaves the metric out of the result line."""

from __future__ import annotations

from cdcbench import core


def span_ms(view, span: str):
    """Mean host milliseconds of a span's calls in the run."""
    calls = view.spans.get(span, [])
    return 1e3 * sum(calls) / len(calls) if calls else None


def launches(view):
    """Device operations (kernels, copies, sets) of the traced slice per
    request."""
    return len(view.ops) / view.requests if view.ops else None


def idle_share(view):
    """Traced time with nothing on the device, % of the traced time."""
    if view.window_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)


def mfu(view):
    """The request's FLOP (the benchmark's count) over the mean host time of
    the untraced requests at the bf16 dense peak of every chip used, %."""
    if not view.per_request:
        return None
    seconds = sum(view.per_request) / len(view.per_request)
    return 100.0 * view.counts["flops"] / (
        seconds * core.PEAK_BF16_FLOPS * view.chips)


def roofline(view, patterns, bound_s: float):
    """A kernel's least time per request over its device time per request,
    %: ``patterns`` pick the kernel's operations in the trace by name."""
    busy = sum(view.device_seconds(p) for p in patterns) / view.requests
    return 100.0 * bound_s / busy if busy > 0 else None
