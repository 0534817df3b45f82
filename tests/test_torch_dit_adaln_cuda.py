"""The DiT's adaLN kernel (``csrc/dit_adaln.cu``) against its plain version,
on the card (``cuda``; every test skips without one).

* The block's three calls (entry: h; mid: x' and h; exit: x') at the served
  DiT-XL/2's (1, 6144, 1152), at ragged rows (7, 6143) and widths (8, 72,
  1000, 1152: the narrowest and the widest row taken), with h in f32 and
  bf16 and y in f32 and bf16: x' bit-equal to ``x + g * y``; h in f32 within
  2e-6 of the plain version relative to the row's scale, (|LN(x')| + 1)·
  |1 + scale| + |shift| (the order of LayerNorm's sums differs, which moves
  the mean and 1/σ of a row by a few ulp); h in bf16 differs from the plain
  version's on at most 0.1 % of the values, each by at most one bf16 step
  beyond that f32 allowance (near h = 0, where a step is tiny, the f32
  difference spans many steps).
* A CUDA graph's capture and replay give the eager call's outputs.
* A launch adds 1 to ``_kernels.LAUNCHES["adaln"]``.
* Where autograd records, the kernel is the forward of ``_AdaLN``: its
  outputs carry a ``grad_fn`` and the gradients are those of autograd
  through the plain version.

On a machine with a card (JAX need not be there, hence ``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_dit_adaln_cuda.py -q
"""

import importlib

import pytest
import torch

from tpucdc_torch.ops import _kernels, adaln

adaln_mod = importlib.import_module("tpucdc_torch.ops.adaln")
pytestmark = pytest.mark.cuda

SHAPES = [(1, 6144, 1152), (1, 7, 72), (1, 7, 1000), (1, 6143, 1152),
          (2, 6143, 1000), (3, 7, 1152), (2, 5, 8)]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
CALLS = {"entry": (False, True), "mid": (True, True), "exit": (True, False)}
F32_REL = 2e-6
BF16_SHARE = 1e-3
# (call, y dtype, h dtype): a call that reads no y or writes no h once.
CASES = [(call, y_dt, h_dt) for call, (res, norm) in CALLS.items()
         for y_dt in (DTYPES if res else ["f32"])
         for h_dt in (DTYPES if norm else ["f32"])]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(card, shape, y_dtype, seed=0):
    """x, y and (shift, scale, gate) as views of one [B, 1, 6C] projection,
    as the block hands them."""
    gen = torch.Generator(card).manual_seed(seed)
    b, n, c = shape
    x = 3.0 * torch.randn(shape, generator=gen, device=card) + 0.5
    y = torch.randn(shape, generator=gen, device=card).to(y_dtype)
    mod = torch.randn((b, 6 * c), generator=gen, device=card)[:, None, :]
    shift, scale, gate, *_ = mod.chunk(6, dim=-1)
    return x, y, shift, scale, gate


def _call(fn, call, x, y, shift, scale, gate, h_dtype):
    res, norm = CALLS[call]
    return fn(x, *((shift, scale, h_dtype) if norm else ()),
              **({"gate": gate, "y": y} if res else {}))


def _row_scale(x_new, shift, scale):
    """(|LN(x')| + 1)·|1 + scale| + |shift|, in float64."""
    xn = torch.nn.functional.layer_norm(x_new.double(), (x_new.shape[-1],),
                                        eps=1e-6)
    return ((xn.abs() + 1.0) * (1.0 + scale.double()).abs()
            + shift.double().abs())


def _bf16_excess(got, want, allowed):
    """How far |got − want| passes one bf16 step at the larger magnitude
    plus ``allowed`` (the f32 difference its rounding can carry), in bf16
    steps; 0 where it does not."""
    g, w = got.double(), want.double()
    top = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
    step = torch.exp2(torch.floor(torch.log2(top)) - 7)
    return ((g - w).abs() - step - allowed).clamp_min(0) / step


@pytest.mark.parametrize("call,y_dt,h_dt", CASES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_kernel_matches_plain(card, shape, call, y_dt, h_dt):
    res, norm = CALLS[call]
    h_dtype = DTYPES[h_dt]
    x, y, shift, scale, gate = _inputs(card, shape, DTYPES[y_dt])
    before = _kernels.LAUNCHES["adaln"]
    got_x, got_h = _call(adaln, call, x, y, shift, scale, gate, h_dtype)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["adaln"] == before + 1
    want_x, want_h = _call(adaln_mod.adaln_reference, call, x, y, shift,
                           scale, gate, h_dtype)
    assert torch.equal(got_x, want_x)
    if not norm:
        assert got_h is None
        return
    assert got_h.dtype == h_dtype and got_h.shape == x.shape
    size = _row_scale(want_x, shift, scale)
    if h_dt == "f32":
        err = ((got_h.double() - want_h.double()).abs() / size).max().item()
        assert err <= F32_REL, err
    else:
        share = (got_h != want_h).float().mean().item()
        excess = _bf16_excess(got_h, want_h, F32_REL * size).max().item()
        assert excess == 0.0 and share <= BF16_SHARE, (excess, share)


def test_graph_replay_is_the_eager_call(card):
    shape = (1, 6144, 1152)
    x, y, shift, scale, gate = _inputs(card, shape, torch.bfloat16, seed=1)
    static = [t.clone() for t in (x, y, shift, scale, gate)]
    stream = torch.cuda.Stream(card)
    stream.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(stream):
        _call(adaln, "mid", *static, torch.bfloat16)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out_x, out_h = _call(adaln, "mid", *static, torch.bfloat16)
    torch.cuda.current_stream(card).wait_stream(stream)
    for seed in (2, 3):
        fresh = _inputs(card, shape, torch.bfloat16, seed=seed)
        for s, f in zip(static, fresh):
            s.copy_(f)
        graph.replay()
        torch.cuda.synchronize()
        want_x, want_h = _call(adaln, "mid", *fresh, torch.bfloat16)
        assert torch.equal(out_x, want_x) and torch.equal(out_h, want_h)


@pytest.mark.parametrize("call", list(CALLS))
def test_autograd_through_the_kernel(card, call):
    res, norm = CALLS[call]
    shape = (2, 77, 1152)
    x, y, shift, scale, gate = _inputs(card, shape, torch.float32, seed=4)
    gen = torch.Generator(card).manual_seed(5)
    weights = [torch.randn(shape, generator=gen, device=card)
               for _ in range(2)]

    def grads(fn):
        leaves = [t.clone().requires_grad_()
                  for t in (x, y, shift, scale, gate)]
        got_x, got_h = _call(fn, call, *leaves, torch.bfloat16)
        loss = 0.0
        if res:
            loss = loss + (got_x * weights[0]).sum()
        if norm:
            assert got_h.grad_fn is not None
            loss = loss + (got_h.float() * weights[1]).sum()
        used = [t for t, on in zip(leaves, (True, res, norm, norm, res))
                if on]
        return torch.autograd.grad(loss, used)

    before = _kernels.LAUNCHES["adaln"]
    got = grads(adaln)
    assert _kernels.LAUNCHES["adaln"] == before + 1
    for g, w in zip(got, grads(adaln_mod.adaln_reference)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
