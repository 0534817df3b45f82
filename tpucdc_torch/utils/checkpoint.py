"""Checkpoints and resume, mirroring tpucdc/utils/checkpoint.py.

A run directory holds one subdirectory per saved step, ``<step>/state.pt``:
the parameters, the EMA parameters, the optimizer's state and the step,
written by ``torch.save``. Restoring the step resumes the batch stream too,
since the crop iterator is deterministic in its batch index (``start=``).
The EMA weights also go out as ``save_params_npz`` files
(``utils.weights``), which the JAX package reads.

The JAX package's run directories are orbax checkpoints, which need JAX to
read; the port does not read them, and JAX does not read the port's.

Over a mesh, ``pipelines.train.fit`` saves on rank 0 alone, after every
rank has gathered a ``"tensor"`` state to full (``TrainState.state_dict``), so
the file is the one a replicated run writes and either layout restores it
(a sharded state keeps its slices).
"""

from __future__ import annotations

import pathlib
import shutil
import threading
from typing import Optional

import torch

STATE_FILE = "state.pt"


def _to_cpu(obj):
    """A copy of ``obj`` with every tensor cloned to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


class CheckpointManager:
    """Save and restore ``pipelines.train.TrainState`` by step.

    ``save`` copies the state to the host at once and writes it on a
    background thread (one write at a time); ``wait=True``, the next
    ``save`` and ``close`` wait for the write. Only the newest
    ``max_to_keep`` steps are kept.
    """

    def __init__(self, directory, max_to_keep: int = 3):
        self.directory = pathlib.Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def steps(self) -> list[int]:
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / STATE_FILE).exists())

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state, wait: bool = False) -> None:
        """Write ``state`` (a state dict, or an object with
        ``state_dict()``) as ``step`` on a thread."""
        self.wait_until_finished()
        if not isinstance(state, dict):
            state = state.state_dict()
        payload = _to_cpu(state)
        self._writer = threading.Thread(target=self._write,
                                        args=(int(step), payload))
        self._writer.start()
        if wait:
            self.wait_until_finished()

    def _write(self, step: int, payload: dict) -> None:
        try:
            final = self.directory / str(step)
            tmp = self.directory / f".{step}.tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir()
            torch.save(payload, tmp / STATE_FILE)
            shutil.rmtree(final, ignore_errors=True)
            tmp.rename(final)
            for old in self.steps()[:-self.max_to_keep]:
                shutil.rmtree(self.directory / str(old))
        except BaseException as e:  # noqa: BLE001 (raised by the waiter)
            self._error = e

    def wait_until_finished(self) -> None:
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def read(self, step: Optional[int] = None) -> dict:
        """The saved payload of ``step`` (the latest when None), on the
        CPU."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint of the port in {self.directory} (an orbax "
                f"run directory of the JAX package is not read)")
        return torch.load(self.directory / str(step) / STATE_FILE,
                          map_location="cpu", weights_only=True)

    def restore(self, state, step: Optional[int] = None):
        """Load ``step`` (the latest when None) into ``state`` in place and
        return it."""
        self.wait_until_finished()
        state.load_state_dict(self.read(step))
        return state

    def close(self) -> None:
        self.wait_until_finished()
