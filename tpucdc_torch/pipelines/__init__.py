"""User-facing pipelines: the compress/decompress runtime, evaluation and
training."""

from tpucdc_torch.pipelines.codec_runtime import CodecRuntime

__all__ = ["CodecRuntime"]
