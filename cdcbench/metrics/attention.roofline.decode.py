"""attention.roofline.decode: the FLOP bound of a decode's attention calls
(4·B·H·Nq·Nk·d each, at the bf16 dense peak) over their device time in the
traced slice, %. The kernels are found by their names."""

from cdcbench import core, readers

KERNELS = ("attention_mma_kernel", "attention_fma_kernel")


def read(view):
    return readers.roofline(view, KERNELS, view.counts["attention_flops"]
                            / core.PEAK_BF16_FLOPS)
