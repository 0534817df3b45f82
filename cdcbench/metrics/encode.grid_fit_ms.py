"""encode.grid_fit_ms: host ms an encode spends fitting the spatial γ grid
in float64 numpy (the port's ``gamma.grid_fit`` span), median over the
untraced encodes."""

from cdcbench import port_spans


def read(view):
    return port_spans.ms("codec.compress", "gamma.grid_fit")
