"""decode.mfu: the decode's FLOP (g_s, the conditioning head, the hyper stage
or context passes and the UNet steps; the benchmark's own count from the
configuration's shapes) over the mean ms of an untraced decode at the bf16
dense peak, %."""

from cdcbench import readers


def read(view):
    return readers.mfu(view)
