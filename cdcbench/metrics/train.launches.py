"""train.launches: device operations a training step launches on rank 0
(kernels, copies and sets of a traced chunk, per step): autograd's and the
optimizer's host launch work."""

from cdcbench import readers


def read(view):
    return readers.launches(view)
