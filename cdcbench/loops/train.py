"""Training a rate point with the flagship recipe: the port's
``pipelines.train.fit`` over the traffic's data axis (``make_mesh()`` over
one process a card, or no mesh on one card), on seeded crops.

Set-up joins the world, draws the weights from the seed (the reference's
copy of the training initialisation, on every rank alike), makes 24 seeded
512×768 images, and builds one ``TrainState``. It drives that state through
its first three steps by ``fit`` (one step a call, ``steps_per_dispatch``
1, every other setting the recipe's), then through one chunk of K steps,
whose time fixes how many chunks the window runs. The window is one
``fit`` call over those chunks; ``train_img_per_s`` is the global batch's
images over its host time, whole chunks only. With a trace, one chunk of K
steps is profiled first, then the window runs.

``correct``, on rank 0: the reference (f32, plain kernels, the same
weights, crops and per-step draws) follows the first three steps.

* ``loss_gap``: the widest relative gap of a step's loss;
* ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient as the optimizer got it (its first moment after one step over
  1 − β₁) and the reference's clipped gradient, over the larger of that
  leaf's reference norm and the median leaf's (the median of the leaves
  with a gradient: the UNet's zero-initialised output convolution leaves
  every layer below it without one at the first step);
* ``update_gap``: the same of the parameters' change after three steps,
  over the leaves whose reference gradient is at least a thousandth of the
  median leaf's (a gradient nought to rounding moves a leaf by round-off
  alone under Adam).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses

import numpy as np

from cdcbench import core, serving
from cdcbench.reference import codec_ref

TAG_WEIGHTS, TAG_CROPS, TAG_TRAIN = 11, 12, 13
FIRST_STEPS = 3
B1 = 0.9


class State:
    state = None
    mesh = None


def recipe(run: core.Run) -> dict:
    """The configuration file's model with its training recipe applied, and
    the per-step draws seeded from ``--seed``."""
    d = copy.deepcopy(run.config["config"])
    for key, value in run.config["train_recipe"]["overrides"].items():
        *path, leaf = key.split(".")
        node = d
        for part in path:
            node = node[part]
        node[leaf] = value
    d["train"]["seed"] = core.seed_words(run.seed, TAG_TRAIN) % (1 << 31)
    return d


class Crops:
    """Global batches of random crops (and flips) of the pool images, from
    the seed: the same on every rank, each rank training on its slice."""

    def __init__(self, images, batch: int, crop: int, seed: int):
        self.images, self.batch, self.crop = images, batch, crop
        self.rng = core.rng(seed, TAG_CROPS)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        g, c = self.rng, self.crop
        out = np.empty((self.batch, c, c, 3), np.uint8)
        for b in range(self.batch):
            im = self.images[int(g.integers(len(self.images)))]
            i = int(g.integers(im.shape[0] - c + 1))
            j = int(g.integers(im.shape[1] - c + 1))
            patch = im[i:i + c, j:j + c]
            out[b] = patch[:, ::-1] if g.random() < 0.5 else patch
        return out


def initial_weights(run: core.Run, cfg_dict: dict) -> dict:
    """The training initialisation of the reference's model, drawn from
    the seed: a state_dict on the CPU."""
    import torch

    from cdcbench.reference.model import CDCModel
    from cdcbench.reference.utils.weights import init_weights
    model = CDCModel(codec_ref.build_config(cfg_dict).model)
    with torch.no_grad():
        init_weights(model, torch.Generator().manual_seed(
            core.seed_words(run.seed, TAG_WEIGHTS)))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _leaf_norms(tensors: dict) -> dict:
    import torch
    names = list(tensors)
    norms = torch.stack(torch._foreach_norm(
        [tensors[n].to(torch.float32) for n in names]))
    return dict(zip(names, norms.double().cpu().numpy()))


def setup(run: core.Run) -> State:
    import torch

    from tpucdc_torch import config as port_config
    from tpucdc_torch.model import CDCModel
    from tpucdc_torch.pipelines import train as port_train
    from tpucdc_torch.runtime import make_mesh, maybe_init_distributed

    st = State()
    t = run.traffic
    st.cfg_dict = recipe(run)
    cfg = codec_ref.from_dict(port_config.Config, st.cfg_dict).validated()
    st.cfg = cfg
    if t["data"] > 1:
        import torch.distributed as dist
        if not dist.is_initialized():
            maybe_init_distributed(run.device.type)
        st.mesh = make_mesh(device=run.device.type)
    st.weights0 = initial_weights(run, st.cfg_dict)
    model = CDCModel(cfg.model)
    model.load_state_dict(st.weights0, strict=True)
    model.to(run.device)
    st.state = port_train.state_from_model(cfg, model)
    images = [core.seeded_image(t["height"], t["width"], core.seed_words(
        run.seed, serving.TAG_IMAGE, i)) for i in range(t["pool"])]
    st.data = Crops(images, cfg.train.batch_size, cfg.train.crop_size,
                    run.seed)
    st.first = [next(st.data) for _ in range(FIRST_STEPS)]
    feed = iter(st.first)
    one = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, steps_per_dispatch=1, log_every=1))
    st.losses = []

    def writer(step, metrics):
        st.losses.append(metrics["loss"])
    params0 = {n: p.detach().clone()
               for n, p in st.state.model.named_parameters()}
    fit = port_train.fit
    fit(one, feed, mesh=st.mesh, writer=writer, start_state=st.state,
        num_steps=1, device=run.device)
    opt = st.state.opt
    st.grad1 = _leaf_norms({n: m / (1 - B1) for n, m in zip(opt.names,
                                                             opt.mu)})
    fit(one, feed, mesh=st.mesh, writer=writer, start_state=st.state,
        num_steps=FIRST_STEPS - 1, device=run.device)
    st.delta3 = _leaf_norms({n: p.detach() - params0[n] for n, p in
                             st.state.model.named_parameters()})
    del params0
    k = cfg.train.steps_per_dispatch
    t0 = core.now()
    _chunks(run, st, 1)
    chunk_s = core.now() - t0
    n = max(1, int(round(run.seconds / chunk_s)))
    if st.mesh is not None:
        import torch.distributed as dist
        agreed = torch.tensor([n], device=run.device)
        dist.broadcast(agreed, 0)
        n = int(agreed.item())
    st.chunks, st.k = n, k
    return st


def _chunks(run: core.Run, st: State, n: int) -> None:
    from tpucdc_torch.pipelines import train as port_train
    port_train.fit(st.cfg, st.data, mesh=st.mesh, start_state=st.state,
                   num_steps=n * st.cfg.train.steps_per_dispatch,
                   device=run.device)
    serving.sync(run)


def window(run: core.Run, st: State) -> core.Window:
    import torch
    st.profile = None
    steps_img = st.cfg.train.batch_size
    if run.trace:
        from cdcbench import tracing
        with torch.profiler.profile(activities=serving.activities(run)) as p:
            _chunks(run, st, 1)
        st.profile = tracing.read_profile(p)
    st.setup_s = core.now() - run.t0
    t0 = core.now()
    _chunks(run, st, st.chunks)
    seconds = core.now() - t0
    steps = st.chunks * st.cfg.train.steps_per_dispatch
    st.step_s = seconds / steps
    return core.Window(
        metrics={"setup_s": st.setup_s,
                 "train_img_per_s": steps * steps_img / seconds},
        attempted=steps, failed=0)


def trace_view(run: core.Run, st: State, win: core.Window):
    from cdcbench import counts, tracing
    p, k = st.profile, st.cfg.train.steps_per_dispatch
    c = counts.train_counts(st.cfg_dict, st.cfg.train.batch_size // max(
        run.world, 1), st.cfg.train.crop_size)
    busy, window = p["busy_s"], p["window_s"]
    if st.mesh is not None:
        # Busy and traced seconds averaged over the ranks, one a card.
        import torch
        import torch.distributed as dist
        both = torch.tensor([busy, window], dtype=torch.float64,
                            device=run.device)
        dist.all_reduce(both)
        busy, window = (both / run.world).tolist()
    return tracing.TraceView(
        ops=p["ops"], window_s=window, busy_s=busy,
        requests=k, spans={}, per_request=[st.step_s], counts=c,
        workload=run.workload, breakdown=p["breakdown"], chips=1)


def release(st: State) -> None:
    """The ranks part here: rank 0 goes on to the comparison."""
    st.state = None
    if st.mesh is not None:
        import torch.distributed as dist
        dist.barrier()


def reference_steps(run: core.Run, st: State, control: bool = False):
    """(losses, first clipped gradient norms, change norms after three
    steps) of the reference from the same start."""
    import torch

    from cdcbench.reference.model import CDCModel
    from cdcbench.reference.ops.layers import fp8_products
    from cdcbench.reference.runtime import (BF16_POLICY, F32_POLICY,
                                            set_policy)
    from cdcbench.reference.train_ref import RefTrainer
    cfg = codec_ref.build_config(st.cfg_dict)
    model = CDCModel(cfg.model)
    model.load_state_dict(st.weights0, strict=True)
    set_policy(model, BF16_POLICY if control else F32_POLICY)
    model.to(run.device).train()
    codec_ref.pin_f32()
    torch.backends.cuda.matmul.allow_tf32 = control
    torch.backends.cudnn.allow_tf32 = control
    trainer = RefTrainer(cfg, model, run.device)
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses = []
    try:
        with fp8_products() if control else contextlib.nullcontext():
            for k, batch in enumerate(st.first):
                losses.append(trainer.step(torch.from_numpy(batch)))
                if k == 0:
                    grads = _leaf_norms(trainer.opt.last_grads)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    delta = _leaf_norms({n: p.detach() - p0[n]
                         for n, p in model.named_parameters()})
    return losses, grads, delta


def gaps(program, reference) -> dict:
    """The three numbers compared, of ``program`` against ``reference``,
    each (losses, grad norms, change norms)."""
    lp, gp, dp = program
    lr_, gr, dr = reference
    loss = max(abs(a - b) / abs(b) for a, b in zip(lp, lr_))
    # The median leaf of those the first step reaches: a zero-initialised
    # output layer keeps the gradient of every layer below it at 0.
    g_med = float(np.median([g for g in gr.values() if g > 0]))
    grad = max(abs(gp[n] - gr[n]) / max(gr[n], g_med) for n in gr)
    moved = [n for n in dr if gr[n] >= 1e-3 * g_med]
    d_med = float(np.median([dr[n] for n in moved]))
    update = max(abs(dp[n] - dr[n]) / max(dr[n], d_med) for n in moved)
    return {"loss_gap": loss, "grad_gap": grad, "update_gap": update}


def judge(run: core.Run, st: State, win: core.Window) -> list:
    if run.rank != 0:
        return []
    mine = (st.losses, st.grad1, st.delta3)
    ref = reference_steps(run, st)
    got = gaps(mine, ref)
    checks = [core.Check(k, v, run.limits[k]) for k, v in got.items()]
    if run.control:
        ctl = gaps(reference_steps(run, st, control=True), ref)
        checks += [core.Check(f"control_{k}", v, run.limits[k])
                   for k, v in ctl.items()]
    return checks
