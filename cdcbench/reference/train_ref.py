"""The reference training step: frozen copies of the port's
``pipelines/train.py`` pieces that one step of one card runs (the loss, the
learning-rate schedule, optax's AdamW with the global-norm clip and the
quantiles' Adam), in plain PyTorch over the reference model, with the draws
made from the same per-step generator as the port's ``fit`` makes them
(``prng.generator(seed + 1, step)``, ``CDCModel.training_draws`` for the
whole global batch).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from cdcbench.reference.config import Config
from cdcbench.reference.model import CDCModel
from cdcbench.reference.ops.schedules import make_schedule
from cdcbench.reference.runtime import prng

AUX_PARAM = "factorized.quantiles"


def lr_schedule(cfg: Config):
    tc = cfg.train
    peak, warmup = tc.lr, tc.warmup_steps
    decay = max(tc.steps, warmup + 1) - warmup
    alpha = 0.05

    def lr(count: int) -> float:
        if count < warmup:
            return peak * count / warmup
        frac = min(count - warmup, decay) / decay
        return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac))
                       + alpha)
    return lr


def global_norm(tensors) -> torch.Tensor:
    tensors = [t.to(torch.float32) for t in tensors]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class Optimizer:
    """optax's multi_transform as the port writes it out: clip by global
    norm, then AdamW on the main parameters; Adam at ``aux_lr`` on the
    quantiles. The clipped gradients of the last step are kept
    (``last_grads``)."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, cfg: Config, model: torch.nn.Module):
        tc = cfg.train
        named = list(model.named_parameters())
        main = [(n, p) for n, p in named if n != AUX_PARAM]
        aux = [(n, p) for n, p in named if n == AUX_PARAM]
        self.names = [n for n, _ in main + aux]
        self.params = [p for _, p in main + aux]
        self.n_main = len(main)
        self.grad_clip, self.weight_decay = tc.grad_clip, tc.weight_decay
        self.aux_lr = tc.aux_lr
        self.schedule = lr_schedule(cfg)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.last_grads = None

    @torch.no_grad()
    def step(self) -> None:
        n_main = self.n_main
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        norm = global_norm(grads[:n_main])
        scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                            self.grad_clip / norm)
        grads = [*torch._foreach_mul(grads[:n_main], scale), *grads[n_main:]]
        self.last_grads = dict(zip(self.names, grads))
        b1, b2 = self.B1, self.B2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - b2))
        t = np.float32(self.count + 1)
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)
        upd = torch._foreach_div(
            torch._foreach_div(self.mu, bc1),
            torch._foreach_add(torch._foreach_sqrt(
                torch._foreach_div(self.nu, bc2)), self.EPS))
        main = self.params[:n_main]
        if self.weight_decay:
            torch._foreach_add_(upd[:n_main], torch._foreach_mul(
                main, self.weight_decay))
        lr = float(np.float32(self.schedule(self.count)))
        torch._foreach_add_(main, torch._foreach_mul(upd[:n_main], -lr))
        torch._foreach_add_(self.params[n_main:], torch._foreach_mul(
            upd[n_main:], -float(np.float32(self.aux_lr))))
        self.count += 1


def schedule_tables(cfg: Config, device) -> dict:
    sched = make_schedule(cfg.model.schedule.kind,
                          cfg.model.schedule.num_steps)
    return {"sqrt_ab": torch.from_numpy(sched.sqrt_alpha_bars).to(device),
            "sqrt_1mab": torch.from_numpy(
                sched.sqrt_one_minus_alpha_bars).to(device)}


def loss_fn(model: CDCModel, batch: torch.Tensor, tables: dict,
            tc, lpips_fn=None, draws: Optional[dict] = None):
    """loss = bpp + λ·distortion (+ the diffusion terms, + LPIPS) + aux."""
    out = model(batch, tables, train=True, draws=draws)
    axes = tuple(range(1, batch.dim()))
    mse_eps_s = torch.mean(torch.square(out["eps"] - out["eps_hat"]),
                           dim=axes)
    x0_pred = torch.clamp(out["x0_pred"], -1.0, 1.0)
    mse_x0_s = torch.mean(torch.square(out["x0"] - x0_pred), dim=axes)
    if tc.distortion == "eps":
        dist_s = mse_eps_s
    elif tc.distortion == "x0":
        dist_s = mse_x0_s
    else:
        dist_s = mse_eps_s + mse_x0_s
    diff_s = None
    if out["x_bar"] is not None:
        diff_s = dist_s
        dist_s = torch.mean(torch.square(out["x_bar"] - batch), dim=axes)
    if tc.rd_lambdas and out["quality"] is not None:
        lam = torch.tensor(tc.rd_lambdas, dtype=torch.float32,
                           device=batch.device)[out["quality"].long()]
        weighted = torch.mean(lam * dist_s)
    else:
        weighted = tc.rd_lambda * torch.mean(dist_s)
    if diff_s is not None:
        weighted = weighted + tc.diff_weight * torch.mean(diff_s)
    if tc.lpips_weight > 0.0 and lpips_fn is not None:
        weighted = weighted + tc.lpips_weight * lpips_fn(x0_pred, batch)
    return out["bpp_y"] + out["bpp_z"] + weighted + model.aux_loss()


class RefTrainer:
    """One card's training step of the reference over ``model`` (already on
    ``device``): step k draws from ``prng.generator(seed + 1, k)`` for the
    whole batch, as the port's ``fit`` does."""

    def __init__(self, cfg: Config, model: CDCModel, device):
        from cdcbench.reference.eval.lpips import PerceptualMetric
        self.cfg, self.model, self.device = cfg, model, torch.device(device)
        self.tables = schedule_tables(cfg, self.device)
        self.opt = Optimizer(cfg, model)
        self.lpips = (PerceptualMetric(device=self.device).distance
                      if cfg.train.lpips_weight > 0 else None)
        self.step_count = 0

    def step(self, batch_u8: torch.Tensor) -> float:
        batch = batch_u8.to(self.device, torch.float32) * (1.0 / 127.5) - 1.0
        gen = prng.generator(self.cfg.train.seed + 1, self.step_count,
                             device=self.device)
        draws = self.model.training_draws(
            tuple(batch.shape), self.tables["sqrt_ab"].shape[0],
            generator=gen, device=self.device)
        for p in self.model.parameters():
            p.grad = None
        loss = loss_fn(self.model, batch, self.tables, self.cfg.train,
                       self.lpips, draws)
        loss.backward()
        self.opt.step()
        self.step_count += 1
        return float(loss.detach())
