"""Carry flax checkpoints across: the JAX package's flat params → a state_dict.

``tpucdc/utils/checkpoint.py::save_params_npz`` writes one array per leaf,
keyed by its ``jax.tree_util.keystr`` path, e.g.
``['params']['unet']['down_res_0_0']['conv1']['kernel']``. The port's modules
carry the flax names, so the mapping is mechanical:

  * flax list members ``down_res_0_0`` become ``down_res.0.0`` (ModuleLists),
    as do the context models' ``heads_G_I``, ``anchor_heads_G_I``,
    ``ctx_convs_G`` and ``fuse_G_I``, and the DiT's ``blocks_I``;
  * a resampler's auto-named ``Conv_0`` is the port's ``conv``;
  * ``kernel`` becomes ``weight``: a conv's HWIO is transposed to OIHW, a
    Dense (in, out) to (out, in), and a ConvTranspose kernel is flipped in
    both spatial axes and laid out [in, out, kh, kw];
  * GN ``scale``/``bias``, GDN ``beta_r``/``gamma_r``, the factorized-prior
    arrays, the variable-rate ``gains``/``inv_gains`` and the DiT's
    ``null_class`` are copied as they are.

The DiT refiner (``diffusion.dit``) has no JAX counterpart; its arrays take
the same layout under ``['params']['dit']``, e.g.
``['params']['dit']['blocks_0']['qkv']['kernel']``.

Every array of a checkpoint maps onto the model, so
``CDCModel.load_state_dict(strict=True)`` raises on a key either side lacks.

``params_to_jax`` is the inverse: a state_dict in the JAX package's key
layout, which ``save_params_npz`` writes and JAX's ``load_params_npz`` reads.

``init_weights`` is the training initialisation, flax's in distribution and
the JAX package's constants exactly. ``draw_weights`` fills a model that
serves without a checkpoint (the large ``flagship`` preset) from a seeded
generator; it draws the UNet's zero-initialised head and the DiT's
zero-initialised adaLN and final layers too, so it is no training
initialisation.
"""

from __future__ import annotations

import pathlib
import re

import numpy as np
import torch

_LIST_MEMBER = re.compile(
    r"^(down_res|down_attn|down_xattn|up_res|up_attn|up_xattn|"
    r"downsamplers|upsamplers|heads|anchor_heads|ctx_convs|fuse|blocks)"
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


def _flax_module_path(parts: list[str]) -> list[str]:
    """The port's dotted module path → flax's module names."""
    out, i = [], 0
    while i < len(parts):
        p = parts[i]
        if p in _LIST_NAMES:
            # A ModuleList member: one index (ctx_convs_G) or two (heads_G_I).
            idx = [parts[i + 1]]
            i += 2
            if i < len(parts) and parts[i].isdigit():
                idx.append(parts[i])
                i += 1
            out.append(p + "_" + "_".join(idx))
            continue
        out.append("Conv_0" if p == "conv" else p)
        i += 1
    return out


_LIST_NAMES = {"down_res", "down_attn", "down_xattn", "up_res", "up_attn",
               "up_xattn", "downsamplers", "upsamplers", "heads",
               "anchor_heads", "ctx_convs", "fuse", "blocks"}


def params_to_jax(state: dict) -> dict:
    """A state_dict → the flat flax params ``save_params_npz`` writes: the
    inverse of ``params_from_jax``, key for key and array for array."""
    flat = {}
    for name, value in state.items():
        parts = name.split(".")
        module, leaf = parts[:-1], parts[-1]
        arr = value.detach().cpu().numpy().astype(np.float32)
        if leaf == "weight":
            dotted = ".".join(module)
            if arr.ndim == 4 and _TRANSPOSED.match(dotted):
                arr = np.flip(arr.transpose(2, 3, 0, 1), (0, 1))
            elif arr.ndim == 4:
                arr = arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 2:
                arr = arr.T
            leaf = "kernel"
        key = "".join(f"['{p}']" for p in
                      ["params", *_flax_module_path(module), leaf])
        flat[key] = np.ascontiguousarray(arr)
    return flat


def jax_last_axis(name: str, ndim: int) -> int:
    """The dim of the port's parameter ``name`` that holds the last axis of
    the flax leaf it maps onto (the transposes of ``params_from_jax``): a
    conv weight's (OIHW) and a dense weight's (out, in) dim 0, a transposed
    conv weight's ([in, out, kh, kw]) dim 1, and the last dim of every
    other leaf, which is stored as in JAX."""
    module, _, leaf = name.rpartition(".")
    if leaf == "weight" and ndim == 4 and _TRANSPOSED.match(module):
        return 1
    if leaf == "weight" and ndim in (2, 4):
        return 0
    return ndim - 1


def save_params_npz(state: dict, path) -> None:
    """Write a state_dict as the JAX package's ``save_params_npz`` would
    write the same parameters: one compressed .npz, flax keystr keys."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **params_to_jax(state))


# flax's lecun_normal: a normal truncated at ±2σ, scaled so that the variance
# after the truncation is 1/fan_in (the constant is the truncated normal's
# standard deviation at unit σ).
_TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def init_weights(model: torch.nn.Module,
                 generator: torch.Generator | None = None) -> None:
    """Initialise ``model`` for training as flax initialises the JAX model.

    In distribution: every convolution, transposed convolution and dense
    weight lecun-normal (a truncated normal of variance 1/fan_in), the
    factorized prior's biases U(−½, ½), all drawn from ``generator``. As the
    JAX package's constants: every bias 0, GroupNorm scales 1 and biases 0,
    GDN β_r = 1 and γ_r = 0.1·I, the factorized prior's matrices, factors
    and quantiles (``FactorizedPrior.reset_parameters``), the gains 1, and
    the UNet's output convolution 0. A DiT refiner is initialised as DiT
    does where the JAX package has no constant: adaLN-Zero (every
    modulation Dense and the final Dense 0) and the null class row
    N(0, 0.02²).
    """
    from tpucdc_torch.codec.entropy_models import FactorizedPrior
    from tpucdc_torch.codec.transforms import GDN
    from tpucdc_torch.ops.layers import Conv, ConvTranspose, Dense

    done = set()
    for name, mod in model.named_modules():
        if isinstance(mod, (Conv, ConvTranspose, Dense)):
            w = mod.weight
            fan_in = w.numel() // w.shape[1 if isinstance(mod, ConvTranspose)
                                          else 0]
            std = fan_in ** -0.5 / _TRUNCATED_STD
            w.copy_(torch.nn.init.trunc_normal_(
                torch.empty(w.shape), 0.0, std, -2 * std, 2 * std,
                generator=generator))
            mod.bias.zero_()
        elif isinstance(mod, GDN):
            mod.beta_r.fill_(1.0)
            mod.gamma_r.copy_(0.1 * torch.eye(mod.gamma_r.shape[0]))
        elif isinstance(mod, FactorizedPrior):
            mod.reset_parameters(generator)
        else:
            continue
        done.update(f"{name}.{p}" if name else p
                    for p, _ in mod.named_parameters(recurse=False))
    for name, p in model.named_parameters():
        if name in done:
            continue
        leaf = name.rsplit(".", 1)[-1]
        if leaf.endswith("scale") or leaf in ("gains", "inv_gains"):
            p.fill_(1.0)
        elif leaf == "null_class":
            p.copy_(0.02 * torch.randn(p.shape, generator=generator))
        elif leaf.endswith("bias"):
            p.zero_()
        else:
            raise ValueError(f"init_weights: no initialiser for {name}")
    unet = getattr(model, "unet", None)
    if unet is not None:
        unet.conv_out.weight.zero_()
    dit = getattr(model, "dit", None)
    if dit is not None:
        for dense in [b.adaLN for b in dit.blocks] + [dit.final_adaLN,
                                                      dit.final_linear]:
            dense.weight.zero_()


@torch.no_grad()
def draw_weights(module: torch.nn.Module, seed: int,
                 prefixes: tuple[str, ...] = ("",)) -> None:
    """Draw every convolution and dense ``weight`` under ``prefixes`` from
    N(0, 1/fan_in) with a CPU generator seeded with ``seed``, in
    ``named_parameters`` order, so the same seed gives the same model on any
    device. Biases, norm scales and everything else keep the values they were
    constructed with. The UNet's output convolution, which flax initialises
    to zero, is drawn like the rest: with a zero head every net output would
    be zero, whatever the layers before it computed. So are the DiT's adaLN
    modulations and final Dense, which DiT initialises to zero: otherwise
    every block would be the identity.
    """
    gen = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        if (name.endswith(".weight") and p.dim() >= 2
                and name.startswith(prefixes)):
            fan_in = p.numel() // p.shape[0]
            p.copy_(torch.randn(p.shape, generator=gen) / fan_in ** 0.5)
