"""encode.gamma_search_ms: host ms an encode spends in the γ search (the
span around ``CodecRuntime._optimize_gamma``): its served decodes and the grid
fit."""

from cdcbench import readers


def read(view):
    return readers.span_ms(view, "gamma_search")
