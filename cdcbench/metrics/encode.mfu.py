"""encode.mfu: the encode's FLOP (analysis, the passes, and the γ search's
served decodes; the benchmark's own count) over the mean ms of an untraced
encode at the bf16 dense peak, %."""

from cdcbench import readers


def read(view):
    return readers.mfu(view)
