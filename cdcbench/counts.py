"""The benchmark's own counts of one request's work, worked out from the
configuration's shapes by running the reference on the meta device: no
data, no card, the same count whatever later implements the work.

* FLOP: ``torch.utils.flop_counter.FlopCounterMode`` over the reference's
  products (convolutions, matrix products, attention's two products).
* GN+SiLU bytes: every call reads its input once and writes its output once
  in the dtype the port's policy gives it, and reads γ and β (f32) once.
* Attention FLOP: 4·B·H·Nq·Nk·d a call (q·kᵀ and p·v).

Every FLOP is counted against the bf16 dense peak, whatever precision runs
it, so a share of the peak from these counts is a lower estimate.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.flop_counter import FlopCounterMode

from cdcbench.reference import codec_ref
from cdcbench.reference.diffusion import blocks
from cdcbench.reference.model import CDCModel
from cdcbench.reference.ops.schedules import make_schedule
from cdcbench.reference.runtime import BF16_POLICY, F32_POLICY, set_policy
from cdcbench.reference.sampling.ddim import ddim_sample, ddim_step_tables

META = torch.device("meta")


@contextlib.contextmanager
def _recording(calls: dict):
    """Record the shapes and dtypes of the reference's GN+SiLU and attention
    calls while the block is open."""
    gn, attn = blocks.group_norm_silu, blocks.attention

    def gn_rec(x, gamma, beta, num_groups, eps=1e-5):
        calls["gn_silu"].append((tuple(x.shape), x.dtype, gamma.numel()))
        return gn(x, gamma, beta, num_groups, eps)

    def attn_rec(q, k, v, scale=None):
        calls["attention"].append((tuple(q.shape), tuple(k.shape)))
        return attn(q, k, v, scale)
    blocks.group_norm_silu, blocks.attention = gn_rec, attn_rec
    try:
        yield
    finally:
        blocks.group_norm_silu, blocks.attention = gn, attn


def _meta_model(cfg):
    """The reference model on the meta device under the port's policy: the
    BF16 policy, h_s and the context models in f32."""
    model = CDCModel(cfg.model).to(META).eval()
    set_policy(model, BF16_POLICY)
    set_policy(model.h_s, F32_POLICY)
    if hasattr(model, "context"):
        set_policy(model.context, F32_POLICY)
    return model


class _Meter:
    def __init__(self):
        self.flops = 0
        self.calls = {"gn_silu": [], "attention": []}

    @contextlib.contextmanager
    def __call__(self):
        counter = FlopCounterMode(display=False)
        with _recording(self.calls), counter, torch.inference_mode():
            yield
        self.flops += counter.get_total_flops()


def _entropy_stage(model, cfg, h, w):
    """The hyper stage and the y passes of one image on meta tensors."""
    c = cfg.model.codec
    z_hat = torch.zeros((1, h // 64, w // 64, c.hyper_channels), device=META)
    if c.context == "hyperprior":
        return model.hyper_decode(z_hat)[0]
    feats = model.hyper_features(z_hat)
    y = torch.zeros((1, h // 16, w // 16, c.latent_channels), device=META)
    mg = c.latent_channels // c.context_groups
    for g in range(c.context_groups):
        y_prev = y[..., :g * mg]
        if c.context == "channel-ar":
            model.ctx_group_params(g, feats, y_prev)
        elif c.context == "space-channel":
            model.sc_anchor_params(g, feats, y_prev)
            model.sc_nonanchor_params(g, feats, y_prev, y[..., g * mg:(g + 1) * mg])
        else:
            model.ctx_anchor_params(feats)
            model.ctx_nonanchor_params(feats, y)
            break
    return y


def _device_stage(model, cfg, h, w):
    c = cfg.model.codec
    y_hat = torch.zeros((1, h // 16, w // 16, c.latent_channels), device=META)
    cond_f, cond_t = model.cond_signal(y_hat)
    x_bar = model.synthesize(y_hat)
    steps = cfg.sample.steps
    if steps == 0:
        return
    schedule = make_schedule(cfg.model.schedule.kind,
                             cfg.model.schedule.num_steps)
    frac, T = cfg.sample.truncate_frac, cfg.model.schedule.num_steps
    t_start = max(1, int(round(frac * (T - 1)))) if frac > 0 else T - 1
    ddim_sample(lambda x_t, t: model.denoise(x_t, t, cond_f, cond_t, x_bar),
                schedule, (1, h, w, 3), num_steps=steps,
                noise=torch.zeros((1, h, w, 3), device=META), device=META,
                x_ref=x_bar,
                tables=ddim_step_tables(schedule, steps, cfg.sample.eta,
                                        t_start),
                prediction=cfg.model.prediction)


def _padded(n: int) -> int:
    return n + (-n) % codec_ref.PAD_MULTIPLE


def decode_counts(config: dict, height: int, width: int) -> dict:
    """One served decode: the entropy stage and the device stage."""
    cfg = codec_ref.build_config(config)
    h, w = _padded(height), _padded(width)
    model, m = _meta_model(cfg), _Meter()
    with m():
        _entropy_stage(model, cfg, h, w)
        _device_stage(model, cfg, h, w)
    return _summary(m)


def encode_counts(config: dict, height: int, width: int,
                  search_decodes: int) -> dict:
    """One encode: the analysis and the y passes, then ``search_decodes``
    served decodes of the fresh bitstream (the γ search)."""
    cfg = codec_ref.build_config(config)
    h, w = _padded(height), _padded(width)
    model, m = _meta_model(cfg), _Meter()
    with m():
        y = model.g_a(torch.zeros((1, h, w, 3), device=META))
        model.h_a(y)
        _entropy_stage(model, cfg, h, w)
    one = decode_counts(config, height, width)
    out = _summary(m)
    for k in ("flops", "gn_silu_bytes", "attention_flops"):
        out[k] += search_decodes * one[k]
    out["gn_silu_calls"] += search_decodes * one["gn_silu_calls"]
    out["attention_calls"] += search_decodes * one["attention_calls"]
    return out


def train_counts(config: dict, batch: int, crop: int) -> dict:
    """One training step at ``batch`` crops of ``crop``²: the training
    forward (codec, g_s, head, UNet, the LPIPS proxy when the recipe weighs
    it), the loss and its backward. The optimizer's element-wise work has
    no products and counts nothing."""
    from cdcbench.reference import train_ref
    from cdcbench.reference.eval.lpips import PerceptualMetric
    cfg = codec_ref.build_config(config)
    model = CDCModel(cfg.model).to(META).train()
    set_policy(model, BF16_POLICY)
    tables = train_ref.schedule_tables(cfg, META)
    lpips = (PerceptualMetric(device=META).distance
             if cfg.train.lpips_weight > 0 else None)
    m = _Meter()
    counter = FlopCounterMode(display=False)
    with _recording(m.calls), counter:
        x = torch.zeros((batch, crop, crop, 3), device=META)
        loss = train_ref.loss_fn(model, x, tables, cfg.train, lpips)
        loss.backward()
    m.flops = counter.get_total_flops()
    return _summary(m)


def gn_silu_bytes(calls) -> int:
    total = 0
    for shape, dtype, channels in calls:
        n = 1
        for s in shape:
            n *= s
        total += 2 * n * torch.empty((), dtype=dtype).element_size()
        total += 2 * channels * 4
    return total


def attention_flops(calls) -> int:
    total = 0
    for (b, heads, nq, d), (_, _, nk, _) in calls:
        total += 4 * b * heads * nq * nk * d
    return total


def _summary(m: _Meter) -> dict:
    return {"flops": int(m.flops),
            "gn_silu_calls": len(m.calls["gn_silu"]),
            "gn_silu_bytes": gn_silu_bytes(m.calls["gn_silu"]),
            "attention_calls": len(m.calls["attention"]),
            "attention_flops": attention_flops(m.calls["attention"])}
