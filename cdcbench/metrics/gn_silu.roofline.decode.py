"""gn_silu.roofline.decode: the byte bound of a decode's GN+SiLU calls (each
input read once, each output written once, at 3.35 TB/s) over their device
time in the traced slice, %. The kernel is found by its name."""

from cdcbench import core, readers

KERNELS = ("gn_silu_kernel",)


def read(view):
    return readers.roofline(view, KERNELS, view.counts["gn_silu_bytes"]
                            / core.PEAK_HBM_BYTES)
