"""train.forward_ms: host ms a training step spends in the loss's forward
(the port's ``train.forward`` span: the model, the rate and the LPIPS
proxy), median over the untraced chunks of K steps."""

from cdcbench import port_spans


def read(view):
    return port_spans.ms("train.chunk", "train.forward", per_step=True)
