"""Carry flax checkpoints across: the JAX package's flat params → a state_dict.

``tpucdc/utils/checkpoint.py::save_params_npz`` writes one array per leaf,
keyed by its ``jax.tree_util.keystr`` path, e.g.
``['params']['unet']['down_res_0_0']['conv1']['kernel']``. The port's modules
carry the flax names, so the mapping is mechanical:

  * flax list members ``down_res_0_0`` become ``down_res.0.0`` (ModuleLists),
    as do the context models' ``heads_G_I``, ``anchor_heads_G_I``,
    ``ctx_convs_G`` and ``fuse_G_I``;
  * a resampler's auto-named ``Conv_0`` is the port's ``conv``;
  * ``kernel`` becomes ``weight``: a conv's HWIO is transposed to OIHW, a
    Dense (in, out) to (out, in), and a ConvTranspose kernel is flipped in
    both spatial axes and laid out [in, out, kh, kw];
  * GN ``scale``/``bias``, GDN ``beta_r``/``gamma_r``, the factorized-prior
    arrays and the variable-rate ``gains``/``inv_gains`` are copied as they
    are.

Every array of a checkpoint maps onto the model, so
``CDCModel.load_state_dict(strict=True)`` raises on a key either side lacks.
"""

from __future__ import annotations

import pathlib
import re

import numpy as np
import torch

_LIST_MEMBER = re.compile(
    r"^(down_res|down_attn|down_xattn|up_res|up_attn|up_xattn|"
    r"downsamplers|upsamplers|heads|anchor_heads|ctx_convs|fuse)"
    r"_(\d+(?:_\d+)?)$")
_TRANSPOSED = re.compile(r"^(g_s|h_s)\.deconv\d+$")


def _path(key: str) -> list[str]:
    parts = re.findall(r"\['([^']+)'\]", key)
    if not parts or parts[0] != "params" or "".join(
            f"['{p}']" for p in parts) != key:
        raise KeyError(f"not a flax params keystr: {key!r}")
    return parts[1:]


def _torch_module_path(parts: list[str]) -> str:
    out = []
    for p in parts:
        m = _LIST_MEMBER.match(p)
        if m:
            out.append(m.group(1) + "." + m.group(2).replace("_", "."))
        elif p == "Conv_0":
            out.append("conv")
        else:
            out.append(p)
    return ".".join(out)


def params_from_jax(flat: dict) -> tuple[dict, list[str]]:
    """Flat flax params → (torch state_dict, keys that map onto nothing).

    The second list is empty for every checkpoint of the JAX package; it is
    kept so that a caller can assert that nothing was dropped.
    """
    state, unused = {}, []
    for key in sorted(flat):
        parts = _path(key)
        arr = np.asarray(flat[key], np.float32)
        module = _torch_module_path(parts[:-1])
        leaf = parts[-1]
        if leaf == "kernel":
            if arr.ndim == 4 and _TRANSPOSED.match(module):
                arr = np.flip(arr, (0, 1)).transpose(2, 3, 0, 1)
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:
                arr = arr.T
            else:
                raise ValueError(f"{key}: unexpected kernel rank {arr.ndim}")
            leaf = "weight"
        name = f"{module}.{leaf}" if module else leaf
        state[name] = torch.from_numpy(np.array(arr, copy=True))
    return state, unused


def load_params_npz(path) -> tuple[dict, list[str]]:
    """Read a ``save_params_npz`` file into (state_dict, unused keys)."""
    with np.load(pathlib.Path(path)) as data:
        return params_from_jax({k: data[k] for k in data.files})
