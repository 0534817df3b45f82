"""The benchmark's CPU tests import ``cdcbench`` and the port from the
checkout's root, at four threads."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

torch.set_num_threads(4)
