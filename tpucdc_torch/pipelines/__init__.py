"""User-facing pipelines: the compress/decompress runtime."""

from tpucdc_torch.pipelines.codec_runtime import CodecRuntime

__all__ = ["CodecRuntime"]
