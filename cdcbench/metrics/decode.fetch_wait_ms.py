"""decode.fetch_wait_ms: host ms a decode waits on device → host transfers
(the port's ``codec.fetch`` spans: the row indexes of every y pass and the
image), median over the untraced decodes."""

from cdcbench import port_spans


def read(view):
    return port_spans.ms("codec.decompress", "codec.fetch")
