"""The training loop, checkpoints, the data iterators, the named random
streams and the ``train`` entry points, on the CPU at the tiny preset.

* ``fit``: a run resumed from a checkpoint (with the crop iterator started
  at the checkpoint's batch) equals the uninterrupted run exactly; K = 2 steps
  a loop iteration equal K = 1; a total that K does not divide raises; a
  failing data iterator raises out of ``fit`` (which crops inline) and does
  not hang; ``fault_inject_step`` exits with 42 (several ranks:
  tests/test_torch_dist_train.py).
* ``Prefetcher`` (behind ``grain_crop_iterator``) relays its producer's
  exception and closes its thread.
* ``CheckpointManager``: save, restore, ``latest_step``, ``max_to_keep``;
  ``save_params_npz`` of the port's parameters is read by the JAX package's
  ``load_params_npz`` to the same arrays.
* ``KeyChain``: streams are stable and independent, on JAX's tag hash.
* ``grain_crop_iterator``: byte-equal to the JAX package's (grain) and to
  ``train_crop_iterator``.
* ``python -m tpucdc_torch train`` writes the λ-tagged run directory;
  ``api.train`` returns (model, state); ``load_runtime`` on the run
  directory serves the EMA weights, and its own round trip is exact.
"""

import dataclasses
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tpucdc.data import grain_pipeline as jax_grain
from tpucdc.runtime import prng as jax_prng
from tpucdc.utils.checkpoint import load_params_npz as jax_load_params_npz

from tests._torch_jax_helpers import (ROOT, assert_round_trip_exact,
                                      flat_params,
                                      one_torch_thread_per_module,  # noqa: F401
                                      port_init_pair, tiny_config)
from tpucdc_torch import api, presets
from tpucdc_torch.cli.main import main
from tpucdc_torch.data import (Prefetcher, grain_crop_iterator,
                               train_crop_iterator)
from tpucdc_torch.pipelines import train
from tpucdc_torch.runtime import KeyChain
from tpucdc_torch.runtime.prng import _tag_to_int
from tpucdc_torch.utils import save_params_npz
from tpucdc_torch.utils.checkpoint import CheckpointManager

IMAGES = [np.random.default_rng(i).integers(0, 256, (80, 96, 3),
                                            dtype=np.uint8) for i in range(3)]
SMALL = {"train.batch_size": 2, "train.warmup_steps": 2, "train.steps": 8,
         "train.lr": 1e-3, "train.log_every": 1}


def _cfg(**extra):
    return api.build_config("tiny", {**SMALL, **extra})


def _data(cfg, start=0):
    return train_crop_iterator(IMAGES, cfg.train.batch_size,
                               cfg.train.crop_size, seed=cfg.train.seed,
                               as_uint8=True, start=start)


def _params(state):
    return {n: p.detach().clone() for n, p in state.model.named_parameters()}


def _assert_states_equal(a, b):
    assert a.step == b.step and a.opt.count == b.opt.count
    pa, pb = _params(a), _params(b)
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
        assert torch.equal(a.ema_params[n], b.ema_params[n]), n


@pytest.fixture(scope="module")
def straight():
    """Four uninterrupted steps, K = 1, with their logged metrics."""
    cfg = _cfg()
    rows = []
    _, state = train.fit(cfg, _data(cfg), writer=lambda s, m: rows.append(m),
                         num_steps=4, device="cpu")
    return cfg, state, rows


def test_fit_logs_every_step(straight):
    _, state, rows = straight
    assert state.step == 4 and len(rows) == 4
    for row in rows:
        assert {"loss", "bpp", "mse_eps", "mse_x0", "aux", "mse_gs",
                "grad_norm", "steps_per_sec"} <= set(row)
        assert all(np.isfinite(v) for v in row.values())


def test_resumed_run_equals_uninterrupted(straight, tmp_path):
    cfg, want, _ = straight
    ckpt = CheckpointManager(tmp_path / "ckpt")
    cfg2 = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_every=2))
    train.fit(cfg2, _data(cfg), checkpointer=lambda s, st: ckpt.save(s, st),
              num_steps=2, device="cpu")
    ckpt.wait_until_finished()
    assert ckpt.latest_step() == 2
    _, fresh = train.create_state(cfg, seed=123, device="cpu")
    ckpt.restore(fresh)
    assert fresh.step == 2
    _, got = train.fit(cfg, _data(cfg, start=2), start_state=fresh,
                       num_steps=2, device="cpu")
    _assert_states_equal(got, want)


def test_k_steps_per_iteration_equal_single_steps(straight):
    cfg, want, _ = straight
    cfg2 = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, steps_per_dispatch=2))
    rows = []
    _, got = train.fit(cfg2, _data(cfg), writer=lambda s, m: rows.append(m),
                       num_steps=4, device="cpu")
    _assert_states_equal(got, want)
    assert len(rows) == 2           # logging falls on K-step boundaries


def test_fit_rejects_a_total_k_does_not_divide():
    cfg = _cfg(**{"train.steps_per_dispatch": 3})
    with pytest.raises(ValueError, match="multiple of steps_per_dispatch"):
        train.fit(cfg, _data(cfg), num_steps=4, device="cpu")


def test_producer_failure_raises_and_does_not_hang():
    cfg = _cfg(**{"train.steps_per_dispatch": 2})
    finite = iter([next(_data(cfg)) for _ in range(3)])
    with pytest.raises(StopIteration):
        train.fit(cfg, finite, num_steps=4, device="cpu")


def test_fault_inject_step_exits_42(tmp_path):
    script = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(ROOT)!r})
        import numpy as np, torch
        torch.set_num_threads(1)
        from tpucdc_torch import api
        from tpucdc_torch.data import train_crop_iterator
        from tpucdc_torch.pipelines import train
        cfg = api.build_config("tiny", {{"train.batch_size": 1,
                                         "train.fault_inject_step": 1}})
        imgs = [np.zeros((64, 64, 3), np.uint8)]
        rows = []
        train.fit(cfg, train_crop_iterator(imgs, 1, 64, as_uint8=True),
                  writer=lambda s, m: print("step", s, flush=True),
                  num_steps=4, device="cpu")
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode == 42, out.stderr
    assert out.stdout.split() == []     # dies before step 1 completes


def test_prefetcher_relays_and_closes():
    it = iter(range(3))
    pf = Prefetcher(lambda: next(it), depth=2)
    assert [next(pf) for _ in range(3)] == [0, 1, 2]
    for _ in range(2):      # raised again, not lost
        with pytest.raises(StopIteration):
            next(pf)
    pf.close()
    assert not pf._thread.is_alive()


# ---- checkpoints ----

@pytest.fixture(scope="module")
def tiny_state():
    cfg = _cfg()
    return cfg, train.create_state(cfg, seed=0, device="cpu")[1]


def test_checkpoint_manager_save_restore_keep(tiny_state, tmp_path):
    cfg, state = tiny_state
    mngr = CheckpointManager(tmp_path, max_to_keep=2)
    assert mngr.latest_step() is None
    with pytest.raises(FileNotFoundError, match="orbax"):
        mngr.read()
    saved = {}
    for step in (1, 2, 3):
        state.step = step
        with torch.no_grad():
            next(state.model.parameters()).add_(1.0)
        saved[step] = _params(state)
        mngr.save(step, state)
    mngr.close()
    assert mngr.steps() == [2, 3] and mngr.latest_step() == 3
    _, other = train.create_state(cfg, seed=7, device="cpu")
    mngr.restore(other, step=2)
    assert other.step == 2
    for n, p in other.model.named_parameters():
        assert torch.equal(p, saved[2][n]), n
    mngr.restore(other)
    assert other.step == 3


def test_save_params_npz_reads_in_jax(tmp_path):
    cfg = tiny_config(context="channel-ar", num_qualities=3)
    _, params, tm = port_init_pair(cfg, seed=2)
    path = tmp_path / "ema.npz"
    save_params_npz(tm.state_dict(), path)
    got = jax_load_params_npz(path, params)
    a, b = flat_params(got), flat_params(params)
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


# ---- random streams and data ----

def test_keychain_streams_stable_and_independent():
    for tag in ("noise", "dropout", "t"):
        assert _tag_to_int(tag) == jax_prng._tag_to_int(tag)
    kc = KeyChain(0)
    draw = lambda g: torch.rand(4, generator=g)
    assert torch.equal(draw(kc.key("noise", 3)), draw(KeyChain(0).key(
        "noise", 3)))
    streams = [draw(kc.key("noise", 3)), draw(kc.key("dropout", 3)),
               draw(kc.key("noise", 4)), draw(KeyChain(1).key("noise", 3)),
               *map(draw, kc.split("noise", 2, step=3))]
    for i in range(len(streams)):
        for j in range(i):
            assert not torch.equal(streams[i], streams[j]), (i, j)


def test_grain_crop_iterator_byte_equal_to_jax():
    want = jax_grain.grain_crop_iterator(IMAGES, 3, 48, seed=4)
    plain = train_crop_iterator(IMAGES, 3, 48, seed=4)
    got = grain_crop_iterator(IMAGES, 3, 48, seed=4)
    for _ in range(4):
        a, b, c = next(got), next(want), next(plain)
        assert a.dtype == np.float32 and a.tobytes() == b.tobytes()
        assert a.tobytes() == c.tobytes()
    late = grain_crop_iterator(IMAGES, 3, 48, seed=4, start=2)
    assert next(late).tobytes() == next(train_crop_iterator(
        IMAGES, 3, 48, seed=4, start=2)).tobytes()
    got.close()
    late.close()


# ---- entry points ----

def test_cli_train_writes_the_lambda_run_directory(tmp_path):
    sets = [f"--set={k}={v}" for k, v in {
        **SMALL, "train.checkpoint_every": 2, "train.crop_size": 64}.items()]
    main(["train", "--preset", "tiny", "--device", "cpu", "--steps", "2",
          "--workdir", str(tmp_path), *sets])
    run = tmp_path / f"lambda{presets.tiny().train.rd_lambda:g}"
    assert (run / "ckpt" / "2" / "state.pt").exists()
    rows = (run / "logs" / "metrics.jsonl").read_text().splitlines()
    assert len(rows) == 2


def test_api_train_and_load_runtime_serve_the_ema(tmp_path):
    overrides = {**SMALL, "train.checkpoint_every": 2,
                 "sample.steps": 2, "train.rd_lambda": 16.0}
    model, state = api.train("tiny", steps=2, workdir=str(tmp_path),
                             overrides=overrides, device="cpu")
    assert isinstance(state, train.TrainState) and state.step == 2
    assert model is state.model
    run = tmp_path / "lambda16"
    rt = api.load_runtime("tiny", checkpoint=str(run), overrides=overrides,
                          device="cpu")
    for n, p in rt.model.named_parameters():
        assert torch.equal(p, state.ema_params[n]), n
    raw = api.load_model(api.build_config("tiny", overrides),
                         str(run / "ckpt"), use_ema=False)
    for n, p in raw.named_parameters():
        assert torch.equal(p, state.model.get_parameter(n)), n
    img = np.random.default_rng(0).integers(0, 256, (64, 64, 3),
                                            dtype=np.uint8)
    blob = rt.compress(img)
    assert_round_trip_exact(rt, img, blob)
    assert rt.decompress(blob).shape == img.shape
