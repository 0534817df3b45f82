"""tpucdc_torch — the PyTorch/CUDA port of tpucdc for the NVIDIA H100.

So far it encodes and decodes: ``CodecRuntime.compress`` (image → bitstream,
with the in-band γ search and rate control) and ``CodecRuntime.decompress``
(bitstream → uint8 image) for every entropy model, single-rate or
variable-rate, with classifier-free guidance, DDIM (plain or block-cached) or
DDPM sampling; ``decompress_tiled`` for large images; and the batch
forms ``compress_many`` / ``decompress_many``. Fused GroupNorm+SiLU and
attention are hand-written CUDA kernels. The package imports PyTorch and
never JAX or the tpucdc package. Entry points run on the card unless the
caller passes ``device="cpu"``, where every kernel's plain PyTorch version
runs instead.
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
