"""decode.symbols_ms: host ms a decode spends from the bitstream to the ŷ
symbols and μ on the card (the span around ``CodecRuntime._decode_symbols``):
container parse, z rANS, the hyper stage and every y pass with its fetch and
rANS call."""

from cdcbench import readers


def read(view):
    return readers.span_ms(view, "decode_symbols")
