"""tpucdc_torch stands alone: no JAX, no flax, nothing of tpucdc.

In a subprocess where ``import jax``, ``import flax`` and ``import tpucdc``
fail, the port and every submodule import; a source scan finds no such import
under tpucdc_torch/ or in chip_smoke.py.
"""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "tpucdc_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in PORT.rglob("*.py"))

_BLOCK = """
import sys
for name in ("jax", "jaxlib", "flax", "tpucdc"):
    sys.modules[name] = None
import importlib
for name in {modules!r}:
    importlib.import_module(name)
print("ok", len({modules!r}))
"""


# The eval and user-facing layers, which must stay among the modules above.
EVAL_AND_API = {"tpucdc_torch.api", "tpucdc_torch.__main__",
                "tpucdc_torch.cli", "tpucdc_torch.cli.main",
                "tpucdc_torch.data", "tpucdc_torch.data.datasets",
                "tpucdc_torch.eval", "tpucdc_torch.eval.metrics",
                "tpucdc_torch.eval.lpips", "tpucdc_torch.eval.fid",
                "tpucdc_torch.eval.harness",
                "tpucdc_torch.pipelines.evaluate",
                "tpucdc_torch.utils.logging", "tpucdc_torch.utils.profiling"}


# The training layers, which must stay among the modules above.
TRAINING = {"tpucdc_torch.pipelines.train", "tpucdc_torch.utils.checkpoint",
            "tpucdc_torch.data.grain_pipeline", "tpucdc_torch.runtime.prng",
            "tpucdc_torch.runtime.debug", "tpucdc_torch.utils.weights",
            "tpucdc_torch.codec.entropy_models"}


def test_port_imports_without_jax_or_tpucdc():
    assert EVAL_AND_API <= set(MODULES) and TRAINING <= set(MODULES)
    out = subprocess.run(
        [sys.executable, "-c", _BLOCK.format(modules=MODULES)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", str(len(MODULES))]


_FORBIDDEN = re.compile(
    r"^\s*(?:import\s+(?:jax|jaxlib|flax|tpucdc)\b(?!_torch)"
    r"|from\s+(?:jax|jaxlib|flax|tpucdc)\b(?!_torch))", re.M)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_tpucdc_import_in_source(path):
    assert not _FORBIDDEN.findall(path.read_text())
