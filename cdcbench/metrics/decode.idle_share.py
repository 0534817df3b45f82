"""decode.idle_share: % of the traced slice of served decodes with nothing
running on the card."""

from cdcbench import readers


def read(view):
    return readers.idle_share(view)
