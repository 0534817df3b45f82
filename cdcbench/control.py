"""The readings that a cell's correctness limits are set from, on the card:
the port's numbers over many seeds (the lower readings); the control's, the
reference computed in the next precision below the configuration's (the
port's bf16 products in fp8 with one scale per tensor, its f32 ones in
TF32), on the first few of them (the upper readings); and, with
``--fault``, the numbers of a run whose training step is broken in the
port. The benchmark's own runs never run it.

    python3 cdcbench/control.py --workload <name> --seeds 1,2,3,... \
        [--seconds 5] [--control-seeds 3] [--fault half|unchanged|no_exchange]

Each seed is a whole run of the cell in this process (set-up, a short window
at the cell's own load, the comparison); rank 0 prints one JSON line a
seed. A cell on several chips runs one process a card, as ``run.py`` does.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from cdcbench import core, run  # noqa: E402

FAULTS = ("half", "unchanged", "no_exchange")


def plant(fault: str, patch=setattr) -> None:
    """Break the port's training step in this process: ``unchanged`` (the
    optimizer leaves the state as it was), ``half`` (the loss of half the
    batch), ``no_exchange`` (each rank keeps its own gradients). ``patch``
    is ``setattr`` or a test's ``monkeypatch.setattr``."""
    from tpucdc_torch.pipelines import train
    if fault == "unchanged":
        patch(train.Optimizer, "step",
              lambda self: setattr(self, "count", self.count + 1))
    elif fault == "half":
        real = train.loss_fn

        def half(model, batch, *a, **k):
            if k.get("draws") is not None:
                k["draws"] = {n: v[:batch.shape[0] // 2]
                              for n, v in k["draws"].items()}
            return real(model, batch[:batch.shape[0] // 2], *a, **k)
        patch(train, "loss_fn", half)
    elif fault == "no_exchange":
        patch(train, "_mean_grads", lambda model, group, n: None)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--fault", choices=FAULTS)
    args = p.parse_args(argv)
    os.environ.update(core.cache_env())
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    manifest = core.load_json(ROOT / "BENCHMARK.json")
    chips = run.cell_files(manifest, args.workload)[0]["chips"]
    if chips > 1 and "RANK" not in os.environ:
        from cdcbench import ranks
        return ranks.launch(pathlib.Path(__file__),
                            sys.argv[1:] if argv is None else argv, chips)
    torch.set_num_threads(4)
    if args.fault:
        plant(args.fault)
    rank0 = int(os.environ.get("RANK", "0")) == 0
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = run.execute(run.parse(["--workload", args.workload, "--seed",
                                     str(seed), "--seconds",
                                     str(args.seconds)]),
                          manifest=manifest,
                          control=k < args.control_seeds and not args.fault)
        if rank0:
            print(json.dumps({
                "workload": args.workload, "seed": seed, "fault": args.fault,
                "attempted": res["attempted"], "failed": res["failed"],
                "checks": {c.name: float(c.value) for c in res["_checks"]},
                "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
