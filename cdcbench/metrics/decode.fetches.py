"""decode.fetches: device → host transfers a decode waits for (the port's
``codec.fetch`` spans), median over the untraced decodes."""

from cdcbench import port_spans


def read(view):
    return port_spans.calls("codec.decompress", "codec.fetch")
