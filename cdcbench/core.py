"""What every loop shares: the run's context, seeds, the seeded images, the
cache directories, the card's name and power limit, and the statistics.

Nothing here imports the port; the loops do.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import time
from typing import Any

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "cdcbench"
CACHE = BENCH / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tpucdc")

# Published dense peaks of one H100 SXM (NVIDIA's data sheet, 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def cache_env() -> dict:
    """Fixed cache directories inside the checkout, and no JAX behind any
    library's back. The port builds its kernels into its own
    ``tpucdc_torch/_build/``, also inside the checkout."""
    return {"TRITON_CACHE_DIR": str(CACHE / "triton"),
            "CUDA_CACHE_PATH": str(CACHE / "nv"),
            "TORCHINDUCTOR_CACHE_DIR": str(CACHE / "inductor"),
            "USE_FLAX": "0", "USE_JAX": "0"}


def seed_words(seed: int, *tags: int) -> int:
    """A 63-bit seed derived from ``seed`` and ``tags``: the same for the
    same arguments, independent across them."""
    ss = np.random.SeedSequence([seed % (1 << 64), *tags])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(seed_words(seed, *tags))


def seeded_image(h: int, w: int, seed: int) -> np.ndarray:
    """An HWC uint8 image from a numpy seed: smooth colour fields, a few hard
    edges and some grain, so that a codec has structure to code (a copy of
    ``chip_smoke.py::seeded_image``)."""
    g = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for _ in range(12):
        fy, fx = g.uniform(0.5, 12.0, 2) * 2 * np.pi / np.array([h, w])
        wave = np.sin(fy * yy + fx * xx + g.uniform(0, 2 * np.pi))
        img += wave[..., None] * g.uniform(-30, 30, 3)
    for _ in range(40):
        y0, x0 = g.integers(0, h), g.integers(0, w)
        dy, dx = g.integers(16, h // 4), g.integers(16, w // 4)
        img[y0:y0 + dy, x0:x0 + dx] += g.uniform(-60, 60, 3)
    img += 128 + g.normal(0, 3, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def quantile(values, q: float) -> float:
    """The q-quantile of ``values`` (linear between order statistics)."""
    return float(np.quantile(np.asarray(values, np.float64), q))


def card() -> dict:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        name, limit = out[0].split(", ")
        return {"name": name, "power_limit": limit}
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        return {"name": "unknown", "power_limit": "unknown"}


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Check:
    """One number compared with its limit; ``ok`` when value ≤ limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


@dataclasses.dataclass
class Run:
    """One run of one cell."""
    workload: str
    seed: int
    seconds: float
    trace: bool
    chips: int
    config: dict                  # the configuration file
    traffic: dict                 # the traffic file
    limits: dict                  # the cell's limits file
    device: Any = None            # torch.device of this rank
    t0: float = 0.0               # process start, perf_counter
    rank: int = 0
    world: int = 1
    control: bool = False         # judge the reference in fp8 (control runs)


@dataclasses.dataclass
class Window:
    """What a loop's window hands back: the end-to-end metrics by name,
    and the requests attempted and failed."""
    metrics: dict
    attempted: int
    failed: int


def now() -> float:
    return time.perf_counter()
