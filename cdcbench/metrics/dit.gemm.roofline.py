"""dit.gemm.roofline: the FLOP bound of a decode's dense products in the DiT
(``dit_gemm_flops``: 2·M·K·N of the blocks', the timestep embedder's and the
final layer's products, at the bf16 dense peak; the benchmark's count,
``counts_dit``) over the device time of the matrix-product kernels in the
traced slice, %.

The matrix-product kernels are cuBLAS's and cuBLASLt's, found by name: a
kernel whose name holds one of ``MATCH`` and none of ``SKIP`` (on an H100
with CUDA 12.8, cuBLASLt's ``nvjet_tst_*`` kernels). ``SKIP``
leaves out cuDNN's convolutions (the codec's, g_s's, the conditioning
head's and the patch embed's: ``implicit_gemm``, ``fprop``, ``dgrad``,
``wgrad``, ``conv``) and the attention kernels. The few products of the
decode outside the DiT (the conditioning head's token projection) are
timed and not counted, so the share is a lower estimate."""

from cdcbench import core

MATCH = ("gemm", "gemv", "nvjet")
SKIP = ("implicit_gemm", "fprop", "dgrad", "wgrad", "conv", "attention")


def matched(name: str) -> bool:
    low = name.lower()
    return any(m in low for m in MATCH) and not any(s in low for s in SKIP)


def read(view):
    flops = view.counts.get("dit_gemm_flops")
    busy = sum(o.end_us - o.start_us for o in view.ops
               if matched(o.name)) / 1e6 / view.requests
    if not flops or busy <= 0:
        return None
    return 100.0 * flops / core.PEAK_BF16_FLOPS / busy
