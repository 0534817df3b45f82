"""decode.rans_ms: host ms a decode spends in the C++ rANS coder (the port's
``rans.decode`` spans: the z stream and every y stream), median over the
untraced decodes."""

from cdcbench import port_spans


def read(view):
    return port_spans.ms("codec.decompress", "rans.decode")
