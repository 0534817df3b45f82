"""The ``evaluate`` pipeline verb: the eval harness under
tpucdc_torch.pipelines, beside compress/decompress (methods of
codec_runtime.CodecRuntime)."""

from tpucdc_torch.eval.harness import (EvalOptions, aggregate,
                                       evaluate_dataset, evaluate_image,
                                       rd_sweep, step_guidance_sweep,
                                       time_decode)

__all__ = ["EvalOptions", "aggregate", "evaluate_dataset", "evaluate_image",
           "rd_sweep", "step_guidance_sweep", "time_decode"]
