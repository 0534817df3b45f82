"""User-facing pipelines: the serving decode runtime."""

from tpucdc_torch.pipelines.codec_runtime import CodecRuntime

__all__ = ["CodecRuntime"]
