"""train.backward_ms: host ms a training step waits in ``loss.backward()``
(the port's ``train.backward`` span: autograd and both kernels' backward),
median over the untraced chunks of K steps."""

from cdcbench import port_spans


def read(view):
    return port_spans.ms("train.chunk", "train.backward", per_step=True)
