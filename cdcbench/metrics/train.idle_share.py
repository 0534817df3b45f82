"""train.idle_share: % of a traced chunk of K training steps with nothing
running on the card, averaged over the ranks."""

from cdcbench import readers


def read(view):
    return readers.idle_share(view)
