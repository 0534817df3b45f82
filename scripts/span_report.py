#!/usr/bin/env python3
"""What the port's spans say about one benchmark cell, on one card.

    python3 scripts/span_report.py --workload flagship-decode --seed 7 \\
        [--seconds 51]

Runs the cell once as ``cdcbench/run.py --trace 1`` does (set-up, the
window with its traced slice, the per-layer metrics, the comparison), in
this process, and then reads the port's records
(``tpucdc_torch.utils.profiling``) of the cell's requests outside the
traced slice. Prints one JSON object and writes it to
``chiprun_out/span_report/<workload>.json``:

- ``stages``: per span name, the median over the requests of its self ms
  and of its calls, and of its counts;
- ``root_self``: the root's own time (not under a child span) as a share
  of the request, median and largest;
- ``wrappers``: the median of ``codec.decode_symbols`` (of ``gamma.search``)
  against that of the benchmark's own timer around ``_decode_symbols``
  (``_optimize_gamma``), over the window's requests outside the traced
  slice, where the stage runs once a request;
- ``annotations``: the traced slice's ``tpucdc.*`` events on the device,
  by whether the profiler flags them as user annotations (only those it
  flags are left out of the device operations);
- ``no_op_share``: the idle seconds the breakdown puts down to no host
  operation, over the slice's idle seconds (``window_s`` − ``busy_s``),
  and ``no_op_detail``, those seconds by the innermost port stage open and
  by the host event that started last before each gap;
- ``span_us``: a span's host cost with no profiler and with one recording
  (the CPU and the card), in µs, from 20000 and 2000 spans;
- the result line's metrics, breakdown and device.

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
ROOTS = {"decode": "codec.decompress", "encode": "codec.compress",
         "train": "train.chunk"}
WRAPPED = {"decode_symbols": "codec.decode_symbols",
           "gamma_search": "gamma.search"}


def span_cost_us(profiling, torch) -> dict:
    """µs a span costs, nested in a request, without and with a profiler."""
    out = {}
    for label, n in (("off", 20000), ("on", 2000)):
        prof = None
        if label == "on":
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        with profiling.span("cost.request"):
            t0 = time.perf_counter()
            for _ in range(n):
                with profiling.span("cost.span"):
                    pass
            dt = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
        out[label] = 1e6 * dt / n
    return out


def no_op_detail(prof, torch, tracing) -> dict:
    """The idle gaps the breakdown puts down to no host operation (none
    open among the 400 host events before the gap's midpoint, as
    ``tracing`` looks), in seconds by the innermost ``tpucdc.*`` range open
    at the midpoint, however far back it opened, and by the host event
    that started last before it."""
    cuda = torch.autograd.DeviceType.CUDA
    ops, host = [], []
    for e in prof.profiler.kineto_results.events():
        a, d = e.start_ns() / 1e3, e.duration_ns() / 1e3
        if e.device_type() == cuda:
            if not (e.is_user_annotation()
                    or e.name().startswith(tracing.SPAN_PREFIX)) and d > 0:
                ops.append((a, a + d))
        else:
            host.append((a, a + d, e.name()))
    if not ops:
        return {}
    host.sort()
    starts = [h[0] for h in host]
    ranges = [h for h in host if h[2].startswith("tpucdc.")]
    busy = tracing._union(ops)
    edges = [busy[0][0]] + [x for se in busy for x in se] + [busy[-1][1]]
    by_range, by_last = collections.Counter(), collections.Counter()
    for k in range(0, len(edges) - 1, 2):
        lo, hi = edges[k], edges[k + 1]
        if hi <= lo:
            continue
        mid = 0.5 * (lo + hi)
        i = bisect.bisect_right(starts, mid) - 1
        if any(host[j][1] > mid for j in range(i, max(i - 400, -1), -1)):
            continue
        inner = [r for r in ranges if r[0] <= mid < r[1]]
        owner = max(inner)[2] if inner else "(no tpucdc range)"
        by_range[owner] += (hi - lo) / 1e6
        by_last[host[i][2] if i >= 0 else "(none)"] += (hi - lo) / 1e6
    return {"by_range": by_range.most_common(12),
            "by_last_event": by_last.most_common(12)}


def stages(profiling, records) -> dict:
    """Median self ms, calls and counts of each span name per request."""
    names = sorted({s[2] for r in records for s in r.spans})
    out = {}
    for name in names:
        row = {"self_ms": statistics.median(
                   profiling.self_ms(r, name) for r in records),
               "calls": statistics.median(
                   profiling.calls(r, name) for r in records)}
        keys = {k for r in records for s in r.spans if s[2] == name and s[5]
                for k in s[5]}
        for k in sorted(keys):
            row[k] = statistics.median(profiling.count(r, name, k)
                                       for r in records)
        out[name] = row
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    a = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from cdcbench import core, run, tracing
    from cdcbench.spans import Spans
    from tpucdc_torch.utils import profiling

    installed = []
    install = Spans.install

    def keep(self, runtime):
        installed.append(self)
        install(self, runtime)
    Spans.install = keep
    annotations = collections.Counter()
    detail = {}
    read_profile = tracing.read_profile

    def count_annotations(prof):
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cuda and e.name().startswith("tpucdc."):
                annotations["user_annotation" if e.is_user_annotation()
                            else "counted_as_device_op"] += 1
        detail.update(no_op_detail(prof, torch, tracing))
        return read_profile(prof)
    tracing.read_profile = count_annotations

    os.environ.update(core.cache_env())
    manifest = core.load_json(ROOT / "BENCHMARK.json")
    _, _, traffic, _ = run.cell_files(manifest, a.workload)
    torch.set_num_threads(traffic.get("threads", 1))
    args = run.parse(["--workload", a.workload, "--seed", str(a.seed),
                      "--seconds", str(a.seconds), "--trace", "1"])
    result = run.execute(args, manifest=manifest)
    checks = result.pop("_checks")

    root = ROOTS[traffic["loop"]]
    records = [r for r in profiling.requests()
               if r.name == root and not r.profiled]
    report = {"workload": a.workload, "seed": a.seed, "card": core.card(),
              "requests": len(records),
              "correct": all(c.ok for c in checks),
              "metrics": result["metrics"], "device": result["device"],
              "breakdown": result["breakdown"],
              "annotations": dict(annotations)}
    idle = result["device"]["window_s"] - result["device"]["busy_s"]
    no_op = dict(result["breakdown"]["idle_gaps"]).get("host (no traced op)")
    report["no_op_share"] = None if no_op is None else no_op / idle
    report["no_op_detail"] = detail
    if records:
        report["stages"] = stages(profiling, records)
        own = [profiling.self_ms(r, root) / profiling.total_ms(r, root)
               for r in records]
        report["root_self"] = {"median": statistics.median(own),
                               "max": max(own)}
        report["request_ms"] = statistics.median(
            profiling.total_ms(r, root) for r in records)
        # The timer's calls of the window's untraced requests against the
        # spans of the same requests, where the stage runs once a request.
        first = traffic.get("trace_after", 0)
        traced = range(first, first + traffic.get("trace_requests", 0))
        wrappers = {}
        for sp in installed:
            for name, seconds in sp.seconds.items():
                theirs = [1e3 * x for k, x in enumerate(seconds)
                          if k not in traced]
                if not theirs or any(profiling.calls(r, WRAPPED[name]) != 1
                                     for r in records):
                    continue
                mine = [profiling.total_ms(r, WRAPPED[name])
                        for r in records][-len(theirs):]
                wrappers[name] = {
                    "span_ms": statistics.median(mine),
                    "wrapper_ms": statistics.median(theirs),
                    "ratio": statistics.median(mine)
                    / statistics.median(theirs), "n": len(theirs)}
        report["wrappers"] = wrappers
    report["span_us"] = span_cost_us(profiling, torch)
    text = json.dumps(report, indent=1)
    print(text)
    out = ROOT / "chiprun_out" / "span_report"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{a.workload}.json").write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
