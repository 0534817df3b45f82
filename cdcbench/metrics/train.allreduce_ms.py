"""train.allreduce_ms: device ms a step of NCCL's all-reduce kernels on rank 0
(the flat gradient buffer and the metrics, averaged over the data group)."""

KERNELS = ("AllReduce",)


def read(view):
    busy = sum(view.device_seconds(k) for k in KERNELS)
    return 1e3 * busy / view.requests if busy > 0 else None
