"""Debug toggles and the multi-process init, mirroring
tpucdc/runtime/debug.py.

``enable_debug_checks`` turns on autograd's anomaly detection, which names
the forward operation whose backward produced a NaN, the counterpart of
``jax_debug_nans``. The JAX package's ``force_op_fallbacks`` has no
counterpart: on the card the port never falls back from a kernel to its
plain version, so there is nothing to force.

``maybe_init_distributed`` joins this process to a ``torch.distributed``
world, the counterpart of ``jax.distributed.initialize``. The port runs one
process per card, so every rank calls the same entry points
(``runtime.mesh``).
"""

from __future__ import annotations

import os

import torch


def enable_debug_checks(nans: bool = True) -> None:
    if nans:
        torch.autograd.set_detect_anomaly(True)


def disable_debug_checks() -> None:
    torch.autograd.set_detect_anomaly(False)


def maybe_init_distributed(device="cuda") -> bool:
    """Join the multi-process world that the environment names; return
    True when the process group is up, False when the environment names
    none. Call it once, before any other process group exists.

    - ``TPUCDC_NUM_PROCESSES`` and ``TPUCDC_PROCESS_ID``: the world at the
      address ``TPUCDC_COORDINATOR`` (else ``COORDINATOR_ADDRESS``),
      host:port, where rank 0 serves the rendezvous (``tcp://``).
    - Else a launcher's ``RANK`` and ``WORLD_SIZE`` (torchrun's): its
      ``MASTER_ADDR`` and ``MASTER_PORT`` name the rendezvous (``env://``),
      the counterpart of JAX's cluster auto-detection; no address is read.
    - An address with neither raises ValueError: it names no world size.

    The backend is NCCL for a CUDA ``device`` and gloo for the CPU; on the
    card the process takes the card ``LOCAL_RANK`` (else its rank modulo
    the cards present) first. A failed init raises: there is no retry and
    no other backend.
    """
    import torch.distributed as dist

    env = os.environ
    addr = env.get("TPUCDC_COORDINATOR") or env.get("COORDINATOR_ADDRESS")
    num = int(env.get("TPUCDC_NUM_PROCESSES", "0") or 0)
    pid = int(env.get("TPUCDC_PROCESS_ID", "-1") or -1)
    if num > 0 and pid >= 0:
        if not addr:
            raise ValueError("TPUCDC_NUM_PROCESSES and TPUCDC_PROCESS_ID "
                             "need TPUCDC_COORDINATOR=host:port")
        rank = pid
        kwargs = dict(init_method=f"tcp://{addr}", world_size=num, rank=pid)
    elif "RANK" in env and "WORLD_SIZE" in env:
        rank = int(env["RANK"])
        kwargs = dict(init_method="env://")
    elif addr:
        raise ValueError(
            f"the coordinator {addr} is set but the world is not: set "
            f"TPUCDC_NUM_PROCESSES and TPUCDC_PROCESS_ID, or launch with "
            f"torchrun")
    else:
        return False
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        local = env.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend, **kwargs)
    return True
