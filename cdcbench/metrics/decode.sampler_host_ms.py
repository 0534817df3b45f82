"""decode.sampler_host_ms: host ms a decode spends issuing the refiner's
UNet steps (the port's ``ddim.step`` spans, summed), median over the
untraced decodes."""

from cdcbench import port_spans


def read(view):
    return port_spans.ms("codec.decompress", "ddim.step")
