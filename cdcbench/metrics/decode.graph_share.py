"""decode.graph_share: the share of a decode's UNet steps that replayed a
CUDA graph (the port's ``unet.replay`` spans over its ``ddim.step`` spans),
%, of the medians over the untraced decodes. None where the decodes hold no
``ddim.step``, or where the port has no graphed denoiser
(``tpucdc_torch.sampling.graphed``) to replay."""

import importlib.util

from cdcbench import port_spans


def _port_graphs() -> bool:
    try:
        return importlib.util.find_spec(
            "tpucdc_torch.sampling.graphed") is not None
    except ImportError:
        return False


def read(view):
    steps = port_spans.calls("codec.decompress", "ddim.step")
    if not steps or not _port_graphs():
        return None
    replays = port_spans.calls("codec.decompress", "unet.replay") or 0
    return 100.0 * replays / steps
