"""Debug toggles, mirroring tpucdc/runtime/debug.py.

``enable_debug_checks`` turns on autograd's anomaly detection, which names
the forward operation whose backward produced a NaN, the counterpart of
``jax_debug_nans``. The JAX package's ``force_op_fallbacks`` has no
counterpart: on the card the port never falls back from a kernel to its
plain version, so there is nothing to force. ``maybe_init_distributed``
comes with multi-GPU support (ROADMAP.md, Queue 1 item 16).
"""

from __future__ import annotations

import torch


def enable_debug_checks(nans: bool = True) -> None:
    if nans:
        torch.autograd.set_detect_anomaly(True)


def disable_debug_checks() -> None:
    torch.autograd.set_detect_anomaly(False)
