"""The DiT's adaLN chain (``ops.adaln``) on the CPU.

* The wrapper's CPU path is bit-equal to the expressions the DiT block ran
  before it (``F.layer_norm`` + ``addcmul``, then the product's cast; ``x + g
  * y``) for the block's three calls and the final layer's, and agrees with
  ``reference/dit.py``'s ``layer_norm`` / ``modulate`` at f32 tolerance.
* ``DiTBlock`` and ``DiT`` at a tiny size give outputs bit-equal to those
  expressions' under both policies, and make 3 calls a block and 1 in the
  final layer.
* The autograd Function (its forward a stand-in for the kernel) gives the
  gradients of autograd through the plain version.
* The refusals: a bad dtype, a width that is not a multiple of 8, a
  non-contiguous input, modulation rows of the wrong shape, CPU tensors.
"""

import dataclasses
import importlib

import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_dit import TINY_DIT, _randomised
from tpucdc_torch.diffusion import dit as dit_mod
from tpucdc_torch.diffusion.dit import IMAGE_CHANNELS, DiT, _depth_to_space
from tpucdc_torch.ops import _kernels, adaln
from tpucdc_torch.reference import dit as ref_dit
from tpucdc_torch.runtime import BF16_POLICY, F32_POLICY

# The wrapper module (the package namespace re-exports its function).
adaln_mod = importlib.import_module("tpucdc_torch.ops.adaln")

B, N, C = 2, 9, 144
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(seed: int, y_dtype=torch.bfloat16):
    """x, y and the six modulation rows as views of one adaLN projection."""
    gen = torch.Generator().manual_seed(seed)
    x = 3.0 * torch.randn((B, N, C), generator=gen) + 0.5
    y = torch.randn((B, N, C), generator=gen).to(y_dtype)
    mod = torch.randn((B, 6 * C), generator=gen)[:, None, :]
    return x, y, mod.chunk(6, dim=-1)


def _parent_norm_modulate(x, shift, scale):
    return torch.addcmul(shift, F.layer_norm(x, (x.shape[-1],), eps=1e-6),
                         1.0 + scale)


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("call", ["entry", "mid", "exit"])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_cpu_path_is_the_parents_expressions(call, dt):
    dtype = DTYPES[dt]
    x, y, (s1, b1, g1, s2, b2, g2) = _inputs(1, dtype)
    if call == "entry":
        got_x, got_h = adaln(x, s1, b1, dtype)
        assert got_x is x
        _same(got_h, _parent_norm_modulate(x, s1, b1).to(dtype))
    elif call == "mid":
        got_x, got_h = adaln(x, s2, b2, dtype, gate=g1, y=y)
        want_x = x + g1 * y
        _same(got_x, want_x)
        _same(got_h, _parent_norm_modulate(want_x, s2, b2).to(dtype))
    else:
        got_x, got_h = adaln(x, gate=g2, y=y)
        assert got_h is None
        _same(got_x, x + g2 * y)


def test_cpu_path_matches_the_reference():
    x, y, (s1, b1, g1, *_) = _inputs(2, torch.float32)
    got_x, got_h = adaln(x, s1, b1, torch.float32, gate=g1, y=y)
    want_x = x + g1 * y
    want_h = ref_dit.modulate(ref_dit.layer_norm(want_x), s1, b1)
    torch.testing.assert_close(got_x, want_x, rtol=0, atol=0)
    torch.testing.assert_close(got_h, want_h, rtol=1e-5, atol=1e-5)


def _parent_block(block, x, c_act):
    """DiTBlock.forward as it was written before ``adaln``."""
    dt = block.policy.compute_dtype
    mod = block.adaLN(c_act, dt).to(torch.float32)[:, None, :]
    s1, b1, g1, s2, b2, g2 = mod.chunk(6, dim=-1)
    x = x + g1 * block._attend(_parent_norm_modulate(x, s1, b1), dt)
    h = F.gelu(block.fc1(_parent_norm_modulate(x, s2, b2), dt),
               approximate="tanh")
    return x + g2 * block.fc2(h, dt)


def _parent_dit(dit, x, t, cond):
    """DiT.forward as it was written before ``adaln``."""
    cfg = dit.config
    h, c_act, (rows, cols) = dit._embed(x, t, cond)
    for block in dit.blocks:
        h = _parent_block(block, h, c_act)
    dt = dit.policy.compute_dtype
    mod = dit.final_adaLN(c_act, dt).to(torch.float32)[:, None, :]
    shift, scale = mod.chunk(2, dim=-1)
    out = dit.final_linear(_parent_norm_modulate(h, shift, scale), dt)
    p, b = cfg.patch, out.shape[0]
    out = out.reshape(b, rows, cols, p, p, -1).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(b, rows * p, cols * p, -1)
    out = out[..., :IMAGE_CHANNELS * cfg.space_to_depth ** 2]
    return _depth_to_space(out.to(torch.float32), cfg.space_to_depth)


@pytest.mark.parametrize("policy", [F32_POLICY, BF16_POLICY],
                         ids=["f32", "bf16"])
def test_dit_is_bit_equal_to_the_parents(policy, monkeypatch):
    cfg = dataclasses.replace(TINY_DIT, in_channels=6, cond_channels=8)
    dit = _randomised(DiT(cfg, policy).eval(), 4)
    gen = torch.Generator().manual_seed(11)
    x = torch.randn((2, 32, 48, 6), generator=gen)
    cond = torch.randn((2, 8, 12, 8), generator=gen)
    t = torch.tensor([5, 600])
    calls = []

    def counted(*args, **kwargs):
        calls.append(("norm" if args[1:] else "") +
                     ("res" if "y" in kwargs else ""))
        return adaln(*args, **kwargs)
    monkeypatch.setattr(dit_mod, "adaln", counted)
    with torch.no_grad():
        tokens, c_act, _ = dit._embed(x, t, cond)
        _same(dit.blocks[0](tokens, c_act),
              _parent_block(dit.blocks[0], tokens, c_act))
        calls.clear()
        _same(dit(x, t, cond), _parent_dit(dit, x, t, cond))
    assert calls == ["norm", "normres", "res"] * cfg.depth + ["norm"]


def _stand_in(monkeypatch):
    """``adaln_cuda`` replaced by its checks and the plain version on the
    CPU, counting a launch as the kernel's wrapper does."""
    def plain(x, shift=None, scale=None, dtype=None, *, gate=None, y=None,
              eps=1e-6):
        adaln_mod.check_inputs(x, shift, scale, dtype, gate=gate, y=y)
        _kernels.LAUNCHES["adaln"] += 1
        return adaln_mod.adaln_reference(x, shift, scale, dtype, gate=gate,
                                         y=y, eps=eps)
    monkeypatch.setattr(adaln_mod, "adaln_cuda", plain)


@pytest.mark.parametrize("call", ["entry", "mid", "exit"])
def test_autograd_function_matches_the_reference(call, monkeypatch):
    _stand_in(monkeypatch)
    x, y, (s1, b1, g1, *_) = _inputs(3, torch.float32)
    res, norm = call != "entry", call != "exit"
    leaves = [x.clone().requires_grad_(),
              s1.clone().requires_grad_() if norm else None,
              b1.clone().requires_grad_() if norm else None,
              g1.clone().requires_grad_() if res else None,
              y.clone().requires_grad_() if res else None]
    gen = torch.Generator().manual_seed(9)
    weights = [torch.randn((B, N, C), generator=gen) for _ in range(2)]

    def loss(x_new, h):
        total = (x_new * weights[0]).sum() if res else 0.0
        return total + ((h * weights[1]).sum() if norm else 0.0)

    before = _kernels.LAUNCHES["adaln"]
    outs = iter(adaln_mod._AdaLN.apply(*leaves, torch.float32, 1e-6))
    got_out = (next(outs) if res else None, next(outs) if norm else None)
    assert _kernels.LAUNCHES["adaln"] == before + 1
    used = [t for t in leaves if t is not None]
    got = torch.autograd.grad(loss(*got_out), used)
    want_out = adaln_mod.adaln_reference(
        leaves[0], leaves[1], leaves[2], torch.float32, gate=leaves[3],
        y=leaves[4])
    want = torch.autograd.grad(loss(*want_out), used)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_refusals():
    x, y, (s1, b1, g1, *_) = _inputs(5)
    check = adaln_mod.check_inputs
    with pytest.raises(TypeError):           # h's dtype
        check(x, s1, b1, torch.float16)
    with pytest.raises(TypeError):           # y's dtype
        check(x, gate=g1, y=y.to(torch.float16))
    with pytest.raises(ValueError):          # x's dtype
        check(x.to(torch.bfloat16), s1, b1, torch.bfloat16)
    with pytest.raises(ValueError):          # a width not a multiple of 8
        check(x[..., :100].contiguous(), s1[..., :100], b1[..., :100],
              torch.bfloat16)
    with pytest.raises(ValueError):          # wider than the kernel holds
        check(torch.zeros(1, 2, 1160), dtype=torch.bfloat16,
              shift=torch.zeros(1, 1, 1160), scale=torch.zeros(1, 1, 1160))
    with pytest.raises(ValueError):          # non-contiguous x
        check(x.transpose(0, 1).contiguous().transpose(0, 1), s1, b1,
              torch.bfloat16)
    with pytest.raises(ValueError):          # non-contiguous y
        check(x, gate=g1, y=y.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError):          # rows not [B, 1, C]
        check(x, s1[:, 0], b1[:, 0], torch.bfloat16)
    with pytest.raises(ValueError):          # a CPU tensor to the launcher
        adaln_mod.adaln_cuda(x, s1, b1, torch.bfloat16)
    with pytest.raises(ValueError):          # shift without scale
        adaln(x, s1, None, torch.bfloat16)
    with pytest.raises(ValueError):          # nothing asked for
        adaln(x)
