"""tpucdc_torch — the PyTorch/CUDA port of tpucdc for the NVIDIA H100.

It encodes and decodes: ``CodecRuntime.compress`` (image → bitstream,
with the in-band γ search and rate control) and ``CodecRuntime.decompress``
(bitstream → uint8 image) for every entropy model, single-rate or
variable-rate, with classifier-free guidance, DDIM (plain or block-cached) or
DDPM sampling; ``decompress_tiled`` for large images; and the batch
forms ``compress_many`` / ``decompress_many``. It evaluates (``eval``:
PSNR, MS-SSIM, GMSD, the LPIPS and FID proxies, the R-D, latency and
perceptual sweeps) and serves through ``api.load_runtime`` and
``python -m tpucdc_torch compress|decompress|eval|rd-sweep``. It trains
(``api.train``, ``python -m tpucdc_torch train``, ``pipelines.train.fit``),
with checkpoints that ``load_runtime`` serves. Over several cards, one
process each (``runtime.make_mesh``, ``torch.distributed``), it trains
data-parallel with the ``"tensor"`` state sharding and shards the tiled
decode (``parallel``).
Fused GroupNorm+SiLU and attention are hand-written CUDA kernels, with a
backward in PyTorch operations. The package
imports PyTorch and never JAX or the tpucdc package. Entry points run on the
card unless the caller passes ``device="cpu"``, where every kernel's plain
PyTorch version runs instead.
"""

from tpucdc_torch.config import Config, ModelConfig, SampleConfig
from tpucdc_torch.model import CDCModel
from tpucdc_torch.pipelines import CodecRuntime
from tpucdc_torch.presets import (flagship, flagship_serving, tiny,
                                  vr_wide_serving)
from tpucdc_torch.runtime import BF16_POLICY, F32_POLICY, Policy
from tpucdc_torch.utils import load_params_npz, params_from_jax

__all__ = ["Config", "ModelConfig", "SampleConfig", "CDCModel",
           "CodecRuntime", "flagship", "flagship_serving", "tiny",
           "vr_wide_serving", "BF16_POLICY", "F32_POLICY", "Policy",
           "load_params_npz", "params_from_jax"]
