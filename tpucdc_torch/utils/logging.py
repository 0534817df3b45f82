"""Metric logging, mirroring tpucdc/utils/logging.py: a JSONL file and a
stderr echo. Every eval row carries the git SHA of the code that made it."""

from __future__ import annotations

import functools
import json
import pathlib
import subprocess
import sys
import time
from typing import Any


@functools.lru_cache(maxsize=1)
def code_sha() -> str:
    """The repository's short git SHA, resolved once per process ("unknown"
    outside a git checkout). A long-lived process keeps the SHA it started
    with, so rows from different code states can be told apart."""
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=pathlib.Path(__file__).resolve().parents[2],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


class MetricLogger:
    """Step-keyed metric writer: ``logdir/metrics.jsonl`` and a stderr echo.
    Callable as ``writer(step, metrics_dict)``.

    ``use_clu`` is kept for the JAX package's signature and does nothing:
    the port writes no TensorBoard summaries, only the JSONL rows.
    """

    def __init__(self, logdir: str | pathlib.Path,
                 use_clu: bool = True, echo: bool = True):
        self.logdir = pathlib.Path(logdir)
        self.logdir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.logdir / "metrics.jsonl", "a", buffering=1)
        self._echo = echo

    def __call__(self, step: int, metrics: dict[str, Any]) -> None:
        row = {"step": step, "time": time.time(), "code_sha": code_sha()}
        row.update({k: float(v) for k, v in metrics.items()
                    if isinstance(v, (int, float))})
        self._jsonl.write(json.dumps(row) + "\n")
        if self._echo:
            skip = ("step", "time", "code_sha")
            parts = " ".join(f"{k}={v:.4g}" for k, v in row.items()
                             if k not in skip)
            print(f"[step {step}] {parts}", file=sys.stderr)

    def write_row(self, row: dict) -> None:
        """A free-form JSONL row (eval results), stamped with the code's git
        SHA unless the caller already set one."""
        row = {**row} if "code_sha" in row else {**row,
                                                "code_sha": code_sha()}
        self._jsonl.write(json.dumps(row, default=float) + "\n")

    def close(self):
        self._jsonl.close()
