"""The benchmark's counts of one served decode with a DiT refiner, worked
out from the configuration's shapes by running the reference on the meta
device, as ``counts.decode_counts`` does for the UNet's decode: the entropy
stage, the conditioning head, g_s and the sampler's steps, each step the
plain DiT of ``reference.dit``.

* ``flops``: ``FlopCounterMode`` over every product of the decode.
* ``attention_flops``: 4·B·H·Nq·Nk·d a call of the DiT's attention (q·kᵀ and
  p·v; d the unpadded head width).
* ``dit_gemm_flops``: 2·M·K·N of each of the DiT's dense products: the
  blocks' (adaLN, qkv, proj, fc1, fc2), the timestep embedder's and the
  final layer's. The patch embed, a convolution in the port, is left out.
"""

from __future__ import annotations

import contextlib

import torch

from cdcbench import counts
from cdcbench.reference import codec_ref
from cdcbench.reference import dit as dit_ref


@contextlib.contextmanager
def _recording(calls: dict):
    """Record the shapes of the DiT's attention calls and dense products
    while the block is open."""
    attn, linear = dit_ref.attention, dit_ref.Linear.forward

    def attn_rec(q, k, v):
        calls["attention"].append((tuple(q.shape), tuple(k.shape)))
        return attn(q, k, v)

    def linear_rec(self, x):
        rows = x.numel() // x.shape[-1]
        calls["gemm"].append(2 * rows * self.weight.shape[0]
                             * self.weight.shape[1])
        return linear(self, x)
    dit_ref.attention, dit_ref.Linear.forward = attn_rec, linear_rec
    try:
        yield
    finally:
        dit_ref.attention, dit_ref.Linear.forward = attn, linear


def decode_counts(config: dict, height: int, width: int) -> dict:
    """One served decode of a ``height``×``width`` image."""
    cfg = codec_ref.build_config(config)
    h, w = counts._padded(height), counts._padded(width)
    model = counts._meta_model(cfg)
    dit = dit_ref.DiTReference.from_config(config["model"]["dit"]).to(
        counts.META)

    def denoise(x_t, t, cond_f, cond_t, x_bar=None):
        return dit(torch.cat([x_t, x_bar], -1), t, cond_f)
    model.denoise = denoise
    m = counts._Meter()
    calls = {"attention": [], "gemm": []}
    with _recording(calls), m():
        counts._entropy_stage(model, cfg, h, w)
        counts._device_stage(model, cfg, h, w)
    return {"flops": int(m.flops),
            "attention_calls": len(calls["attention"]),
            "attention_flops": counts.attention_flops(calls["attention"]),
            "dit_gemm_flops": int(sum(calls["gemm"]))}
