"""train.optimizer_ms: host ms a training step spends in the optimizer and
the EMA over the parameters (the port's ``train.optimizer`` and
``train.ema`` spans), median over the untraced chunks of K steps."""

from cdcbench import port_spans


def read(view):
    return port_spans.ms("train.chunk", "train.optimizer", "train.ema",
                         per_step=True)
