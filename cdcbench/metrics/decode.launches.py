"""decode.launches: device operations a decode launches (kernels, copies and
sets in the traced slice, per decode): the host launch cost of the runtime."""

from cdcbench import readers


def read(view):
    return readers.launches(view)
