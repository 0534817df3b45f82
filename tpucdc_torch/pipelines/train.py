"""Losses, the train step and the training loop, mirroring
tpucdc/pipelines/train.py.

AdamW with a warmup-cosine schedule, a global-norm clip and an EMA of the
parameters; the factorized prior's quantiles train on a separate Adam at
``aux_lr``, as optax's ``multi_transform`` splits them in the JAX package.
The step runs eagerly on each card: K optimizer steps per loop iteration
(``steps_per_dispatch``) take the place of JAX's ``lax.scan``. The JAX
package also crops the next K batches on a producer thread, to overlap that
scan's dispatch; the port has no such dispatch to overlap, and a second
Python thread would only take the interpreter from the thread issuing the
kernels, so ``fit`` crops inline. The JAX package's state is
immutable; the port's step updates the model, the EMA and the optimizer in
place.

Every random draw of a step comes from a generator seeded by (seed + 1,
step), made for the whole global batch (``CDCModel.training_draws``), so a
run does not depend on K or on the number of ranks, and a resumed run
repeats an uninterrupted one. The draws are not JAX's: the tests inject
JAX's (``CDCModel.forward``'s ``draws``).

Over a mesh (``runtime.mesh``, one process per card) every rank runs the
same step on its slice of the global batch: the gradients go through one
``all_reduce`` of a flat buffer over the data group, divided by its size,
before the clip, the optimizers and the EMA, and the metrics are averaged
alike. The mean of the ranks' gradients is the gradient of the global
batch because every loss term is a batch mean (the bpp divides by the
rank's B·H·W, the LPIPS distance is a mean, ``aux_loss`` depends on the
parameters alone). ``param_sharding="tensor"`` holds the EMA and the
moments as this rank's slices on the model axis (``parallel.tp_rules``);
the compute stays whole. ``fit(mesh=None)`` is one card with no
collectives; the JAX package makes a mesh of all local devices there.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

from tpucdc_torch.config import Config
from tpucdc_torch.model import CDCModel
from tpucdc_torch.ops import make_schedule
from tpucdc_torch.parallel.tp_rules import ShardPlan, apply_tp
from tpucdc_torch.runtime import pin_numerics
from tpucdc_torch.runtime import prng
from tpucdc_torch.runtime.device import resolve_device
from tpucdc_torch.runtime.mesh import (DATA_AXIS, axis_group, axis_index,
                                       axis_size, is_rank0, replicate,
                                       shard_batch)
from tpucdc_torch.utils.profiling import span
from tpucdc_torch.utils.weights import init_weights

AUX_PARAM = "factorized.quantiles"


def lr_schedule(cfg: Config):
    """optax's ``warmup_cosine_decay_schedule(0, lr, warmup, max(steps,
    warmup + 1), end_value=0.05·lr)``: the learning rate at a count of
    earlier updates."""
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


class Optimizer:
    """optax's ``multi_transform`` of the JAX package: the main parameters
    get ``clip_by_global_norm(grad_clip)``, then AdamW at the schedule's
    rate (read at the count of earlier updates) and ``weight_decay``; the
    quantiles get Adam at ``aux_lr``, unclipped.

    The arithmetic is optax's, not ``torch.optim``'s: the bias corrections
    1 − β^t are taken in f32 (``torch.optim`` takes them in f64, which moves
    an update by about 1e-5 of itself after a few steps), the decayed weight
    is added to the Adam direction before the rate scales it, and the clip
    divides by the norm before it multiplies by the bound.

    After ``shard(plan)`` the moments are this rank's slices, the update
    writes the rank's slice of each parameter (a view) and the clip's norm
    is still the full gradients'.
    """

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, cfg: Config, model: torch.nn.Module):
        tc = cfg.train
        named = list(model.named_parameters())
        main = [(n, p) for n, p in named if n != AUX_PARAM]
        aux = [(n, p) for n, p in named if n == AUX_PARAM]
        # The main parameters, then the quantiles; mu and nu alike.
        self.names = [n for n, _ in main + aux]
        self.params = [p for _, p in main + aux]
        # What the update writes: the parameters, or this rank's slices.
        self.main = [p for _, p in main]
        self.aux = [p for _, p in aux]
        self.plan: Optional[ShardPlan] = None
        self.grad_clip = tc.grad_clip
        self.weight_decay = tc.weight_decay
        self.aux_lr = tc.aux_lr
        self.schedule = lr_schedule(cfg)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.main + self.aux]
        self.nu = [torch.zeros_like(p) for p in self.main + self.aux]

    def shard(self, plan: ShardPlan) -> None:
        """Keep this rank's slices of the moments and update only its
        slices of the parameters."""
        self.plan = plan
        n_main = len(self.main)
        local = [plan.local(n, p.data) for n, p in zip(self.names,
                                                       self.params)]
        self.main, self.aux = local[:n_main], local[n_main:]
        self.mu = [plan.local(n, m).clone() for n, m in zip(self.names,
                                                            self.mu)]
        self.nu = [plan.local(n, v).clone() for n, v in zip(self.names,
                                                            self.nu)]

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' ``.grad`` (None counts as 0)."""
        n_main = len(self.main)
        with span("optim.clip"):
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in self.params]
            norm = global_norm(grads[:n_main])
            if self.plan is not None:
                grads = [self.plan.local(n, g)
                         for n, g in zip(self.names, grads)]
            main_grads = grads[:n_main]
            # optax: g / ‖g‖ · clip where ‖g‖ ≥ clip, as one factor on the
            # card (no host sync): 1, or clip / ‖g‖.
            scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                self.grad_clip / norm)
            grads = [*torch._foreach_mul(main_grads, scale),
                     *grads[n_main:]]
        b1, b2 = self.B1, self.B2
        with span("optim.moments"):
            torch._foreach_mul_(self.mu, b1)
            torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
            torch._foreach_mul_(self.nu, b2)
            torch._foreach_add_(self.nu, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1 - b2))
        t = np.float32(self.count + 1)
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)
        with span("optim.update"):
            upd = torch._foreach_div(
                torch._foreach_div(self.mu, bc1),
                torch._foreach_add(torch._foreach_sqrt(
                    torch._foreach_div(self.nu, bc2)), self.EPS))
            if self.weight_decay:
                torch._foreach_add_(upd[:n_main], torch._foreach_mul(
                    self.main, self.weight_decay))
            lr = float(np.float32(self.schedule(self.count)))
            torch._foreach_add_(self.main,
                                torch._foreach_mul(upd[:n_main], -lr))
            torch._foreach_add_(self.aux, torch._foreach_mul(
                upd[n_main:], -float(np.float32(self.aux_lr))))
        self.count += 1

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    def load_state_dict(self, state: dict) -> None:
        """Load moments, full (sliced here when sharded) or this rank's."""
        self.count = int(state["count"])
        for name, m, v in zip(self.names, self.mu, self.nu):
            m.copy_(_local_of(self.plan, name, state["mu"][name], m))
            v.copy_(_local_of(self.plan, name, state["nu"][name], v))


def _local_of(plan: Optional[ShardPlan], name: str, value: torch.Tensor,
              like: torch.Tensor) -> torch.Tensor:
    """``value`` as this rank holds it: sliced where it is a full tensor of
    a sharded leaf."""
    if plan is None or value.shape == like.shape:
        return value
    return plan.local(name, value)


def make_optimizer(cfg: Config, model: torch.nn.Module) -> Optimizer:
    return Optimizer(cfg, model)


def global_norm(tensors) -> torch.Tensor:
    """optax.global_norm: √(Σ ‖t‖²) in f32, in a few multi-tensor launches."""
    tensors = [t.to(torch.float32) for t in tensors]
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


@torch.no_grad()
def ema_update(state: "TrainState", ema_decay: float) -> None:
    """EMA with warmup: the decay min(ema_decay, (1+s)/(10+s)) ramps up
    from 0 with the step s before this update (in f32, as in JAX), so the
    average does not carry the random initialisation for tens of
    thousands of steps."""
    s = np.float32(state.step)
    decay = float(np.minimum(np.float32(ema_decay),
                             (np.float32(1) + s) / (np.float32(10) + s)))
    ema = list(state.ema_params.values())
    params = state.local_params()
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, params, alpha=1 - decay)


@dataclasses.dataclass
class TrainState:
    """The step, the model holding the parameters, their EMA (name →
    tensor) and the optimizer, updated in place by the train step.

    ``plan`` is set for ``param_sharding="tensor"`` over a mesh
    (``parallel.tp_rules.apply_tp``): the EMA and the moments are then this
    rank's slices, and the model's full weights are current only after
    ``gather_params``.
    """
    step: int
    model: CDCModel
    ema_params: dict
    opt: Optimizer
    plan: Optional[ShardPlan] = None

    def shard(self, plan: ShardPlan) -> None:
        self.plan = plan
        self.ema_params = {n: plan.local(n, e).clone()
                           for n, e in self.ema_params.items()}
        self.opt.shard(plan)

    def local_params(self) -> list:
        """The parameters as this rank updates them (slices when sharded),
        detached, in ``named_parameters`` order."""
        named = self.model.named_parameters()
        if self.plan is None:
            return [p.detach() for _, p in named]
        return [self.plan.local(n, p.detach()) for n, p in named]

    @torch.no_grad()
    def gather_params(self) -> None:
        """Fill the model's full weights from every rank's slice (a
        collective over the model group)."""
        names, params = zip(*self.model.named_parameters())
        full = self.plan.gather(names, self.local_params())
        for p, f in zip(params, full):
            if f.data_ptr() != p.data_ptr():
                p.copy_(f)

    def state_dict(self) -> dict:
        """The full state: for a sharded state its slices gathered, a
        collective over the model group, so every rank calls it."""
        names = list(self.ema_params)
        ema, mu, nu = (list(self.ema_params.values()), self.opt.mu,
                       self.opt.nu)
        if self.plan is not None and self.plan.sharded:
            self.gather_params()
            ema = self.plan.gather(names, ema)
            mu = self.plan.gather(self.opt.names, mu)
            nu = self.plan.gather(self.opt.names, nu)
        return {"step": self.step, "params": self.model.state_dict(),
                "ema_params": dict(zip(names, ema)),
                "opt_state": {"count": self.opt.count,
                              "mu": dict(zip(self.opt.names, mu)),
                              "nu": dict(zip(self.opt.names, nu))}}

    def load_state_dict(self, state: dict) -> None:
        """Load a full state (a checkpoint); a sharded state keeps this
        rank's slices of it."""
        self.step = int(state["step"])
        self.model.load_state_dict(state["params"], strict=True)
        for name, value in state["ema_params"].items():
            mine = self.ema_params[name]
            mine.copy_(_local_of(self.plan, name, value, mine))
        self.opt.load_state_dict(state["opt_state"])


def state_from_model(cfg: Config, model: CDCModel) -> TrainState:
    """A step-0 TrainState over ``model``'s current parameters: the EMA a
    copy of them, the optimizer fresh."""
    ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    return TrainState(0, model, ema, make_optimizer(cfg, model))


def create_state(cfg: Config, seed: int = 0, mesh=None, device="cuda"
                 ) -> tuple[CDCModel, TrainState]:
    """A freshly initialised model (``utils.init_weights`` from a generator
    seeded with ``seed``) on ``device`` and its step-0 TrainState. Over a
    ``mesh`` every rank calls it: the weights are broadcast from rank 0,
    and ``param_sharding="tensor"`` keeps this rank's slices
    (``apply_tp``)."""
    cfg = cfg.validated()
    model = CDCModel(cfg.model)
    init_weights(model, torch.Generator().manual_seed(seed))
    model.to(resolve_device(device))
    if mesh is not None:
        replicate(model, mesh)
    state = state_from_model(cfg, model)
    if mesh is not None and cfg.train.param_sharding == "tensor":
        apply_tp(state, mesh)
    return model, state


def schedule_tables(cfg: Config, device="cuda") -> dict:
    """The diffusion schedule's √ᾱ and √(1−ᾱ) on ``device`` (the card
    unless the caller passes "cpu")."""
    device = resolve_device(device)
    sched = make_schedule(cfg.model.schedule.kind,
                          cfg.model.schedule.num_steps)
    return {"sqrt_ab": torch.from_numpy(sched.sqrt_alpha_bars).to(device),
            "sqrt_1mab": torch.from_numpy(
                sched.sqrt_one_minus_alpha_bars).to(device)}


def loss_fn(model: CDCModel, batch: torch.Tensor, tables: dict,
            rd_lambda: float, train: bool = True, distortion: str = "eps",
            x0_weight: float = 1.0, rd_lambdas: tuple = (),
            diff_weight: float = 1.0, lpips_weight: float = 0.0,
            lpips_fn=None, draws: Optional[dict] = None,
            generator: Optional[torch.Generator] = None):
    """loss = bpp + λ·distortion + aux, and the metrics (JAX's keys).

    distortion: "eps" (ε-prediction MSE), "x0" (one-step x₀ MSE, x₀ clipped
    to [-1, 1]) or "both". rd_lambdas: a λ per drawn quality (variable
    rate). With codec.synthesis λ weights MSE(x̄, x) alone and the
    diffusion terms get the fixed ``diff_weight``. The LPIPS term is on the
    clipped x₀, the refiner's output, never on x̄.
    """
    out = model(batch, tables, train=train, draws=draws, generator=generator)
    with span("train.loss"):
        axes = tuple(range(1, batch.dim()))
        mse_eps_s = torch.mean(torch.square(out["eps"] - out["eps_hat"]),
                               dim=axes)
        x0_pred = torch.clamp(out["x0_pred"], -1.0, 1.0)
        mse_x0_s = torch.mean(torch.square(out["x0"] - x0_pred), dim=axes)
        if distortion == "eps":
            dist_s = mse_eps_s
        elif distortion == "x0":
            dist_s = mse_x0_s
        elif distortion == "both":
            dist_s = mse_eps_s + x0_weight * mse_x0_s
        else:
            raise ValueError(f"unknown distortion {distortion!r}")
        mse_gs_s = diff_s = None
        if out["x_bar"] is not None:
            mse_gs_s = torch.mean(torch.square(out["x_bar"] - batch), dim=axes)
            diff_s, dist_s = dist_s, mse_gs_s
        if rd_lambdas and out["quality"] is not None:
            lam = torch.tensor(rd_lambdas, dtype=torch.float32,
                               device=batch.device)[out["quality"].long()]
            weighted = torch.mean(lam * dist_s)
        else:
            weighted = rd_lambda * torch.mean(dist_s)
        if diff_s is not None:
            weighted = weighted + diff_weight * torch.mean(diff_s)
        lp = None
        if lpips_weight > 0.0 and lpips_fn is not None:
            with span("train.lpips"):
                lp = lpips_fn(x0_pred, batch)
            weighted = weighted + lpips_weight * lp
        rate = out["bpp_y"] + out["bpp_z"]
        aux = model.aux_loss()
        loss = rate + weighted + aux
        metrics = {"loss": loss, "bpp": rate, "bpp_y": out["bpp_y"],
                   "bpp_z": out["bpp_z"], "mse_eps": torch.mean(mse_eps_s),
                   "mse_x0": torch.mean(mse_x0_s), "aux": aux}
        if mse_gs_s is not None:
            metrics["mse_gs"] = torch.mean(mse_gs_s)
        if lp is not None:
            metrics["lpips_term"] = lp
        return loss, metrics


def make_train_step(cfg: Config, tables: dict, mesh=None):
    """``step_fn(state, batch, generator=None, draws=None) -> metrics``:
    one optimizer step and EMA update of ``state`` in place, on the device
    of ``tables``. A uint8 batch is converted to [-1, 1] there.

    ``batch`` is this rank's slice of the global batch over ``mesh``'s data
    axis (all of it without a mesh). ``draws`` are the global batch's, or
    are made for it from ``generator`` (``CDCModel.training_draws``); each
    rank takes its slice. Over a mesh the gradients and the metrics are
    averaged over the data group; ``grad_norm`` is the averaged gradients'.
    """
    tc = cfg.train
    lpips_fn = None
    if tc.lpips_weight > 0.0:
        from tpucdc_torch.eval.lpips import PerceptualMetric
        metric = PerceptualMetric(device=tables["sqrt_ab"].device)
        lpips_fn = metric.distance
        print(f"[train] lpips term active: kind={metric.kind} "
              f"weight={tc.lpips_weight}", flush=True)
    n_data = 1 if mesh is None else axis_size(mesh, DATA_AXIS)
    index = 0 if mesh is None else axis_index(mesh, DATA_AXIS)
    group = None if mesh is None else axis_group(mesh, DATA_AXIS)
    num_timesteps = tables["sqrt_ab"].shape[0]

    def step_fn(state: TrainState, batch: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                draws: Optional[dict] = None) -> dict:
        with span("train.step"):
            if batch.dtype == torch.uint8:
                batch = batch.to(torch.float32) * (1.0 / 127.5) - 1.0
            b = batch.shape[0]
            with span("train.draws"):
                if draws is None and generator is not None:
                    draws = state.model.training_draws(
                        (b * n_data, *batch.shape[1:]), num_timesteps,
                        generator=generator, device=batch.device)
                if draws is not None and n_data > 1:
                    draws = {k: v[index * b:(index + 1) * b]
                             for k, v in draws.items()}
            with span("train.forward"):
                state.opt.zero_grad()
                if state.plan is not None:
                    state.gather_params()
                loss, metrics = loss_fn(
                    state.model, batch, tables, tc.rd_lambda,
                    distortion=tc.distortion, rd_lambdas=tc.rd_lambdas,
                    diff_weight=tc.diff_weight, lpips_weight=tc.lpips_weight,
                    lpips_fn=lpips_fn, draws=draws, generator=generator)
            with span("train.backward"):
                loss.backward()
                # The autograd graph goes with the last reference to the
                # loss: free it here rather than when the step returns.
                metrics = {k: v.detach() for k, v in metrics.items()}
                del loss
            if mesh is not None:
                with span("train.all_reduce"):
                    _mean_grads(state.model, group, n_data)
                    metrics = _mean_metrics(metrics, group, n_data)
            with span("train.grad_norm"):
                metrics["grad_norm"] = global_norm(
                    p.grad for p in state.model.parameters()
                    if p.grad is not None)
            with span("train.optimizer"):
                state.opt.step()
            with span("train.ema"):
                ema_update(state, tc.ema_decay)
            state.step += 1
            return metrics

    return step_fn


@torch.no_grad()
def _mean_grads(model: torch.nn.Module, group, n: int) -> None:
    """Every parameter's gradient averaged over ``group``: one
    ``all_reduce`` of a flat buffer, divided by ``n``; each ``.grad``
    becomes a view of the buffer (a missing one, zeros)."""
    import torch.distributed as dist

    params = list(model.parameters())
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1) for p in params])
    dist.all_reduce(flat, group=group)
    flat.div_(n)
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad = g.view_as(p)


def _mean_metrics(metrics: dict, group, n: int) -> dict:
    """The metrics averaged over ``group`` in one ``all_reduce``: the
    global batch's, as every term is a batch mean."""
    import torch.distributed as dist

    flat = torch.stack([v.to(torch.float32) for v in metrics.values()])
    dist.all_reduce(flat, group=group)
    flat.div_(n)
    return dict(zip(metrics, flat.unbind()))


def fit(cfg: Config, data_iter: Iterator, mesh=None, writer=None,
        checkpointer=None, start_state: Optional[TrainState] = None,
        num_steps: Optional[int] = None, device="cuda"
        ) -> tuple[CDCModel, TrainState]:
    """The training loop on ``device`` (the card unless the caller passes
    "cpu"). ``data_iter`` yields [B,H,W,3] batches of the global batch
    size, uint8 or [-1, 1] f32. Returns (model, final state).

    ``steps_per_dispatch`` = K: each loop iteration stacks the next K
    batches and takes K optimizer steps on them; metrics are the last
    step's, and logging, checkpoints and ``fault_inject_step`` fall on
    K-step boundaries. On the card, ``fit`` first turns TF32 off for
    matmuls and convolutions, cuDNN's benchmark mode off and its
    deterministic mode on (``runtime.pin_numerics``, the serving runtime's
    settings), so that an f32 gradient is true f32 whatever ran before.

    Over a ``mesh`` every rank calls ``fit`` with the same seeded iterator
    and trains on its slice of each batch (ValueError unless the batch
    divides by the data axis); ``fault_inject_step`` exits every rank,
    ``writer`` and ``checkpointer`` run on rank 0 alone, and every rank
    waits at a barrier after a checkpoint. ``checkpointer(step,
    state_dict)`` gets ``TrainState.state_dict()``, which every rank makes:
    a ``"tensor"`` state is gathered to full, so the file is the one a
    replicated run writes. The returned model holds the full weights.
    """
    cfg = cfg.validated()
    tc = cfg.train
    n_data = 1 if mesh is None else axis_size(mesh, DATA_AXIS)
    if tc.batch_size % n_data:
        raise ValueError(f"batch {tc.batch_size} not divisible by data "
                         f"axis {n_data}")
    with span("train.setup"):
        device = resolve_device(device)
        if device.type == "cuda":
            pin_numerics()
            print("[train] cuda: TF32 off (cudnn.allow_tf32, "
                  "cuda.matmul.allow_tf32), cudnn.benchmark off, "
                  "cudnn.deterministic on", flush=True)
        tables = schedule_tables(cfg, device)
        if start_state is None:
            model, state = create_state(cfg, tc.seed, mesh=mesh, device=device)
        else:
            model, state = start_state.model, start_state
            if (mesh is not None and tc.param_sharding == "tensor"
                    and state.plan is None):
                apply_tp(state, mesh)
        train_step = make_train_step(cfg, tables, mesh)
        rank0 = is_rank0()

    total = num_steps if num_steps is not None else tc.steps
    k = max(tc.steps_per_dispatch, 1)
    if total % k:
        # A partial last chunk would overshoot the schedule's end by up to
        # K-1 steps and shift the cosine decay's endpoint.
        raise ValueError(
            f"num_steps={total} is not a multiple of steps_per_dispatch={k}; "
            f"pick a divisible total (overshoot would run {k - total % k} "
            f"extra steps past the schedule end)")
    t_last, s_last = time.time(), state.step
    done = 0
    while done < total:
        step = state.step
        if (tc.fault_inject_step >= 0
                and step <= tc.fault_inject_step < step + k):
            # Debug hook exercising preemption-safe resume.
            os._exit(42)
        with span("train.chunk", steps=k):
            with span("train.data"):
                if mesh is None:
                    chunk = np.stack([next(data_iter) for _ in range(k)])
                else:
                    chunk = np.stack([shard_batch(next(data_iter), mesh)
                                      for _ in range(k)])
                chunk = torch.from_numpy(chunk).to(device)
            for i in range(k):
                with span("train.seed"):
                    generator = prng.generator(tc.seed + 1, step + i,
                                               device=device)
                metrics = train_step(state, chunk[i], generator)
            done += k
            next_step = step + k
            if (writer is not None and rank0
                    and (next_step % tc.log_every) < k):
                with span("train.log"):
                    m = {key: float(v) for key, v in metrics.items()}
                    now = time.time()
                    m["steps_per_sec"] = (next_step - s_last) / max(
                        now - t_last, 1e-9)
                    t_last, s_last = now, next_step
                    writer(next_step, m)
            if (checkpointer is not None
                    and (next_step % tc.checkpoint_every) < k):
                with span("train.checkpoint"):
                    full = state.state_dict()
                    if rank0:
                        checkpointer(next_step, full)
                    if mesh is not None:
                        import torch.distributed as dist
                        dist.barrier()
    if state.plan is not None and state.plan.sharded:
        state.gather_params()
    return model, state
