"""train.mfu: a step's forward and backward FLOP on one rank's slice of the
batch (the benchmark's own count) over the host time of an untraced step at
the bf16 dense peak, %: every rank does the same."""

from cdcbench import readers


def read(view):
    return readers.mfu(view)
