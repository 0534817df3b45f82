"""Run one cell of the benchmark once, on the card.

    python3 cdcbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is found by name in ``BENCHMARK.json``; its configuration file is
``cdcbench/configs/<config>.json``, its traffic ``cdcbench/traffic/<traffic>
.json``, whose ``loop`` names the module in ``cdcbench/loops/``, and its
correctness limits ``cdcbench/limits/<workload>.json``. A per-layer metric
is ``cdcbench/metrics/<name>.py``. Adding a cell, a configuration, a traffic
mix or a metric adds files and entries; it edits none of this.

The run: set-up (the loop builds the port's runtime or training state,
makes its inputs from ``--seed`` and warms up every shape), the window of
``--seconds`` (the end-to-end metrics, host clock; with ``--trace 1`` a
slice of it under ``torch.profiler`` and the per-layer metrics), then the
peak device memory, then the program's state freed, then the comparison
with the reference that decides ``correct``. The last line on standard
output is the result's JSON; each number compared is printed beside its
limit as the last lines on standard error and under ``checks`` in the
result. A run that finds no card, or too few, exits 3 and prints no result;
one that finds JAX or the JAX package loaded exits 4.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from cdcbench import core  # noqa: E402


def load_module(path: pathlib.Path):
    """A module from a file (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "cdcbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_files(manifest: dict, workload: str) -> tuple[dict, dict, dict, dict]:
    """(cell, configuration file, traffic file, limits file) of a cell."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    cell = cells[workload]
    config = core.load_json(core.BENCH / "configs" / f"{cell['config']}.json")
    traffic = core.load_json(core.BENCH / "traffic" / f"{cell['traffic']}.json")
    limits = core.load_json(core.BENCH / "limits" / f"{workload}.json")
    return cell, config, traffic, limits


def metrics_of(manifest: dict, workload: str, kind: str) -> list[dict]:
    """The manifest's ``end_to_end`` or ``per_layer`` metrics this cell
    reports: those that list it, and those that list no cells."""
    return [m for m in manifest[kind]
            if workload in m.get("workloads", [workload])]


def loop_of(traffic: dict):
    return load_module(core.BENCH / "loops" / f"{traffic['loop']}.py")


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(core.FORBIDDEN))


def execute(args, device=None, manifest=None, control=False) -> dict:
    """Run one cell in this process and return the result's dict (with
    ``checks`` as Check objects under ``_checks``). ``device`` is the card
    of this rank unless a test passes the CPU."""
    import torch
    manifest = manifest or core.load_json(ROOT / "BENCHMARK.json")
    cell, config, traffic, limits = cell_files(manifest, args.workload)
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    run = core.Run(workload=args.workload, seed=args.seed,
                   seconds=args.seconds, trace=bool(args.trace),
                   chips=cell["chips"], config=config, traffic=traffic,
                   limits=limits, device=device, t0=T0, rank=rank,
                   world=world, control=control)
    loop = loop_of(traffic)
    state = loop.setup(run)
    win = loop.window(run, state)
    memory = (torch.cuda.max_memory_allocated(device)
              if device.type == "cuda" else 0)
    view = loop.trace_view(run, state, win) if run.trace else None
    loop.release(state)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = loop.judge(run, state, win)
    result = {"correct": all(c.ok for c in checks),
              "attempted": win.attempted, "failed": win.failed}
    if run.trace:
        metrics = {}
        for m in metrics_of(manifest, args.workload, "per_layer"):
            value = load_module(core.BENCH / "metrics"
                                / f"{m['name']}.py").read(view)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": win.metrics[m["name"]],
                               "unit": m["unit"]}
                   for m in metrics_of(manifest, args.workload, "end_to_end")}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": cell["chips"], "memory_peak_bytes": int(memory)}
    if run.trace:
        result["device"].update(busy_s=view.busy_s, window_s=view.window_s)
        result["breakdown"] = view.breakdown
    result["_checks"] = checks
    return result


def finish(result: dict) -> int:
    """Print the result as the contract asks; the exit code."""
    found = forbidden_loaded()
    if found:
        print(f"cdcbench: the process holds {found}: the benchmark and the "
              f"port may load none of {list(core.FORBIDDEN)}", file=sys.stderr)
        return 4
    checks = result.pop("_checks")
    card = core.card()
    result["device"]["power_limit"] = card["power_limit"]
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    print(json.dumps(result), flush=True)
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr, flush=True)
    return 0


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    os.environ.update(core.cache_env())
    manifest = core.load_json(ROOT / "BENCHMARK.json")
    cell, _, traffic, _ = cell_files(manifest, args.workload)
    import torch
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        print(f"cdcbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    if cell["chips"] > 1 and "RANK" not in os.environ:
        from cdcbench import ranks
        return ranks.launch(ROOT / "cdcbench" / "run.py",
                            sys.argv[1:] if argv is None else argv,
                            cell["chips"])
    # Few threads, as the traffic file says (one where it names none): the
    # host's cores are shared, and a serving loop's host work is Python
    # issuing the device's operations, which a pool does not speed.
    torch.set_num_threads(traffic.get("threads", 1))
    result = execute(args, manifest=manifest)
    code = finish(result) if int(os.environ.get("RANK", "0")) == 0 else 0
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    return code


if __name__ == "__main__":
    sys.exit(main())
