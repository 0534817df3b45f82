"""The port's mesh, its multi-process init and the ``"tensor"`` shard plan
against the JAX package's.

* ``make_mesh`` at world 1 (the process forms it on an in-memory store when
  no process group exists): shape, axis names and coordinates; a mesh that
  wants more ranks than the world has raises ValueError, as JAX's does.
* ``shard_batch``: each rank's slice of the leading dim; a batch the data
  axis does not divide raises ValueError.
* ``leaf_spec`` on tests/integration/test_tensor_parallel.py's cases,
  against JAX's ``leaf_spec``.
* ``tree_shardings`` of the tiny preset at model axis 2 and 4 against
  JAX's on a ``jax.eval_shape`` tree: the same leaves sharded, each on the
  port's dim that holds JAX's last axis, with equal slice sizes.
* tests/integration/test_distributed.py's two-process dry run on the port:
  ``maybe_init_distributed`` from the ``TPUCDC_*`` variables (and from
  torchrun's variables alone), a world of 2 over gloo, an ``all_reduce`` of
  4·(pid+1) giving 12, and the mesh and ``shard_batch`` over it; before the
  init ``make_mesh`` refuses to run alone. Under torchrun's variables the
  ranks run ``eval --mesh --tiled`` through the CLI first, which joins the
  world itself: rank 0 alone prints and logs, and its rows are the rows of
  the same eval in one process. False with no address; an address with no
  world raises.
"""

import json
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucdc.model import CDCModel as JaxCDCModel
from tpucdc.ops import make_schedule as jax_make_schedule
from tpucdc.parallel.tp_rules import leaf_spec as jax_leaf_spec
from tpucdc.parallel.tp_rules import tree_shardings as jax_tree_shardings
from tpucdc.runtime import make_mesh as jax_make_mesh

from tests._torch_jax_helpers import (ROOT, flat_params, tiny_config,
                                      to_torch_config)
from tpucdc_torch.model import CDCModel
from tpucdc_torch.parallel.tp_rules import leaf_spec, tree_shardings
from tpucdc_torch.runtime import (DATA_AXIS, MODEL_AXIS, make_mesh,
                                  maybe_init_distributed, shard_batch)
from tpucdc_torch.utils import params_from_jax


def test_make_mesh_world_of_one():
    mesh = make_mesh(device="cpu")
    assert tuple(mesh.mesh.shape) == (1, 1)
    assert mesh.mesh_dim_names == (DATA_AXIS, MODEL_AXIS) == ("data",
                                                               "model")
    assert tuple(mesh.get_coordinate()) == (0, 0)
    assert tuple(make_mesh(n_data=1, n_model=1, device="cpu").mesh.shape) \
        == (1, 1)


@pytest.mark.parametrize("n_data,n_model", [(2, 1), (1, 2), (2, 2)])
def test_make_mesh_rejects_more_ranks_than_exist(n_data, n_model):
    make_mesh(device="cpu")
    with pytest.raises(ValueError, match="available"):
        make_mesh(n_data=n_data, n_model=n_model, device="cpu")


class _Coords:
    """A stand-in for a DeviceMesh's coordinates: rank ``index`` of a data
    axis of ``n``."""

    mesh_dim_names = ("data", "model")

    def __init__(self, n, index):
        self.n, self.index = n, index

    def size(self, dim):
        return (self.n, 1)[dim]

    def get_coordinate(self):
        return (self.index, 0)


@pytest.mark.parametrize("n,index", [(1, 0), (2, 0), (2, 1), (4, 3)])
def test_shard_batch_takes_the_ranks_slice(n, index):
    batch = {"x": np.arange(8 * 3).reshape(8, 3),
             "t": [torch.arange(8), torch.arange(8) * 2]}
    got = shard_batch(batch, _Coords(n, index))
    lo, hi = index * 8 // n, (index + 1) * 8 // n
    np.testing.assert_array_equal(got["x"], batch["x"][lo:hi])
    assert torch.equal(got["t"][1], torch.arange(lo, hi) * 2)
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(np.zeros((6, 2)), _Coords(4, 0))


@pytest.mark.parametrize("shape,n_model", [
    ((3, 3, 16, 32), 4), ((32,), 4), ((3, 3, 16, 32), 1), ((30,), 4),
    ((), 4)])
def test_leaf_spec_rule_matches_jax(shape, n_model):
    assert leaf_spec(shape, n_model) == tuple(jax_leaf_spec(shape, n_model))


def _jax_tiny_tree(cfg):
    jm = JaxCDCModel(cfg.model.validated())
    sched = jax_make_schedule(cfg.model.schedule.kind,
                              cfg.model.schedule.num_steps)
    tables = {"sqrt_ab": sched.sqrt_alpha_bars,
              "sqrt_1mab": sched.sqrt_one_minus_alpha_bars}
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    return jax.eval_shape(lambda: jm.init(jax.random.key(0), x,
                                          jax.random.key(0), tables))


@pytest.mark.parametrize("n_model", [2, 4])
def test_tree_shardings_match_jax(n_model):
    cfg = tiny_config(context="space-channel", num_qualities=3)
    tree = _jax_tiny_tree(cfg)
    specs = jax_tree_shardings(tree, jax_make_mesh(n_data=8 // n_model,
                                                   n_model=n_model))
    spec_of = {jax.tree_util.keystr(kp): s.spec for kp, s in
               jax.tree_util.tree_flatten_with_path(
                   specs, is_leaf=lambda x: hasattr(x, "spec"))[0]}
    shapes = {k: v.shape for k, v in flat_params(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), tree)).items()}
    model = CDCModel(to_torch_config(cfg).model)
    dims = tree_shardings(model, n_model)
    torch_shapes = {n: p.shape for n, p in model.named_parameters()}
    assert len(dims) == len(spec_of)
    n_sharded = 0
    for key, shape in shapes.items():
        (name,) = params_from_jax({key: np.zeros(shape, np.float32)})[0]
        sharded = len(spec_of[key]) > 0 and spec_of[key][-1] == "model"
        dim = dims[name]
        assert sharded == (dim is not None), (key, name, dim)
        if sharded:
            n_sharded += 1
            # The port's dim holds JAX's last axis: equal slice sizes.
            assert torch_shapes[name][dim] == shape[-1], (key, name, dim)
            assert torch_shapes[name][dim] // n_model == shape[-1] // n_model
    assert n_sharded > 20


_DCN_CHILD = """
import sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from tpucdc_torch.runtime import make_mesh, maybe_init_distributed, shard_batch
try:
    make_mesh(device="cpu")
except RuntimeError as e:
    assert "has not joined" in str(e), e
else:
    raise AssertionError("make_mesh formed a world of 1 inside a world of 2")
eval_argv = {eval_argv!r}
if eval_argv:
    from tpucdc_torch.cli.main import main
    main(eval_argv)
else:
    assert maybe_init_distributed("cpu") is True
assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
pid = dist.get_rank()
# 4 values of pid + 1 a process: 4·1 + 4·2 = 12 over the world.
total = torch.full((4,), pid + 1.0).sum()
dist.all_reduce(total)
mesh = make_mesh(device="cpu")
assert tuple(mesh.mesh.shape) == (2, 1)
assert shard_batch(torch.arange(6), mesh).tolist() == [3 * pid, 3 * pid + 1,
                                                       3 * pid + 2]
print("proc", pid, "ok", float(total), flush=True)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _eval_argv(workdir, mesh: bool) -> list:
    return ["eval", *(["--mesh"] if mesh else []), "--tiled", "--preset",
            "tiny", "--steps", "1", "--no-lpips", "--device", "cpu",
            "--workdir", str(workdir)]


@pytest.mark.parametrize("launch", ["tpucdc", "torchrun"])
def test_two_process_dcn_dryrun(tmp_path, launch, monkeypatch, capsys):
    """The explicit form (``TPUCDC_*``, a ``tcp://`` rendezvous), and
    torchrun's variables alone (``env://``), under which the CLI's ``eval
    --mesh --tiled`` runs first."""
    from PIL import Image

    from tpucdc_torch.cli.main import main

    port = _free_port()
    eval_argv = []
    data = tmp_path / "kodak"
    if launch == "torchrun":
        # One tile, padded to the two ranks: rank 1 decodes the pad tile.
        data.mkdir()
        rng = np.random.default_rng(0)
        Image.fromarray(rng.integers(0, 256, (320, 320, 3), np.uint8)).save(
            data / "0.png")
        eval_argv = _eval_argv(tmp_path / "eval2", mesh=True)
    procs = []
    for pid in range(2):
        env = {"PATH": "/usr/bin:/bin:/usr/local/bin", "HOME": str(tmp_path),
               "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": "",
               "TPUCDC_KODAK_DIR": str(data)}
        if launch == "tpucdc":
            env.update(TPUCDC_COORDINATOR=f"localhost:{port}",
                       TPUCDC_NUM_PROCESSES="2", TPUCDC_PROCESS_ID=str(pid))
        else:
            env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                       RANK=str(pid), WORLD_SIZE="2", LOCAL_RANK=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _DCN_CHILD.format(repo=str(ROOT),
                                                     eval_argv=eval_argv)],
            env=env, cwd=tmp_path, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-2000:]}"
        assert f"proc {pid} ok 12.0" in out
    if launch == "tpucdc":
        return
    printed = [[json.loads(ln) for ln in out.splitlines()
                if ln.startswith("{")] for out in outs]
    assert len(printed[0]) == 1 and printed[1] == []
    logged = (tmp_path / "eval2" / "metrics.jsonl").read_text().splitlines()
    assert len(logged) == 1 + 1
    # The same eval in this process, over its world of 1.
    monkeypatch.setenv("TPUCDC_KODAK_DIR", str(data))
    capsys.readouterr()
    main(_eval_argv(tmp_path / "eval1", mesh=True))
    want = json.loads(capsys.readouterr().out.splitlines()[-1])
    got = printed[0][0]
    assert got["num_images"] == want["num_images"] == 1
    assert got["bpp"] == want["bpp"]
    # A rank's tiles go through the CPU's convolutions at another batch
    # size than in one process, which may move a pixel by 1 LSB (the tiled
    # decode's 1-against-2-rank bound); one such pixel moves the PSNR of
    # these images by under 1e-4 dB.
    assert abs(got["psnr"] - want["psnr"]) <= 1e-3
    assert abs(got["ms_ssim"] - want["ms_ssim"]) <= 1e-4
    assert abs(got["gmsd"] - want["gmsd"]) <= 1e-4


def _no_world(monkeypatch):
    for key in ("TPUCDC_COORDINATOR", "COORDINATOR_ADDRESS",
                "TPUCDC_NUM_PROCESSES", "TPUCDC_PROCESS_ID", "RANK",
                "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)


def test_maybe_init_distributed_without_an_address(monkeypatch):
    _no_world(monkeypatch)
    assert maybe_init_distributed("cpu") is False


def test_maybe_init_distributed_address_without_a_world(monkeypatch):
    """An address alone names no world size: JAX would auto-detect a
    cluster; the port raises instead of guessing."""
    _no_world(monkeypatch)
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1")
    with pytest.raises(ValueError, match="world is not"):
        maybe_init_distributed("cpu")
