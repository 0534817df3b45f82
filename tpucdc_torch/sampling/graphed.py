"""The refiner's denoiser step replayed as a CUDA graph.

A UNet forward at serving size is ~1000 small operations, and the host takes
longer to issue them from Python than the card takes to run them; a DiT
forward (28 blocks) is as many again. The refiner is either one.
``GraphedDenoiser`` runs a net function ``fn(x_t, t, cond_f, cond_t, x_bar)``
(``CDCModel.denoise``, from ``CodecRuntime._sample``) as a
``torch.cuda.CUDAGraph``: the first call of an input shape captures one
forward, and every call of that shape, the first included, copies its
inputs into the graph's static buffers and replays it, one
``cudaGraphLaunch`` a step.

It engages where a graph can stand in for the call: the inputs are on a
CUDA device, under ``torch.inference_mode`` (the runtime's device stage),
and the call comes from the thread and stream that first engaged it; the
static buffers and GN+SiLU's scratch are shared by every replay, so calls
from elsewhere run ``fn`` eagerly, as every call off the card does.

Graphs are kept per key: the device and each input's dtype, shape and
strides (a guided call's doubled batch, or a tile batch, is a key of its
own). At most ``MAX_GRAPHS`` are kept; a new key evicts the least recently
used, and its graph and memory pool go with it.

The returned tensor is the graph's static output: the next call of its key
overwrites it. The samplers consume it in stream order before their next
call and never return it.

Capture: one warm-up forward on the denoiser's own stream (the kernel
library's build, the attention kernel's shared-memory opt-in, cuBLAS's
workspace and GN+SiLU's scratch on that stream, sized for the shape), then
the capture into a private memory pool. GN+SiLU keeps its scratch per
(device, stream) and replaces it when a larger call needs more, so each
graph holds the buffer it was captured with.

``_kernels.LAUNCHES`` counts the launches a path makes through the kernels'
wrappers: the warm-up and the capture are set back, and each replay adds
the captured forward's count, so a graphed decode counts what an eager one
does. A capture opens the span ``unet.capture`` [kernels], a replay
``unet.replay`` (whichever the refiner); the refiner's block spans
(``unet.*``, ``dit.*``) open in the eager forwards only.
"""

from __future__ import annotations

import collections
import threading

import torch

from tpucdc_torch.ops import _kernels, groupnorm
from tpucdc_torch.utils.profiling import span

MAX_GRAPHS = 4


def graph_key(inputs) -> tuple:
    """The inputs' device, dtypes, shapes and strides (None stays None)."""
    return tuple(None if t is None else
                 (t.device, t.dtype, tuple(t.shape), t.stride())
                 for t in inputs)


class CapturedStep:
    """One captured forward: the graph, its static inputs and output, the
    kernel launches it replays, and the GN+SiLU scratch it reads."""

    __slots__ = ("graph", "inputs", "output", "launches", "scratch")

    def __init__(self, graph, inputs, output, launches: dict, scratch=None):
        self.graph = graph
        self.inputs = inputs
        self.output = output
        self.launches = launches
        self.scratch = scratch

    def replay(self, inputs) -> torch.Tensor:
        for static, given in zip(self.inputs, inputs):
            if static is not None:
                static.copy_(given)
        self.graph.replay()
        for name, n in self.launches.items():
            _kernels.LAUNCHES[name] += n
        return self.output


class GraphedDenoiser:
    """Captured denoiser steps of one runtime; see the module's docstring."""

    def __init__(self):
        self._steps: collections.OrderedDict = collections.OrderedDict()
        self._owner = None
        self._stream = None

    def engages(self, x_t: torch.Tensor) -> bool:
        if not x_t.is_cuda or not torch.is_inference_mode_enabled():
            return False
        here = (threading.get_ident(),
                torch.cuda.current_stream(x_t.device).cuda_stream)
        if self._owner is None:
            self._owner = here
        return here == self._owner

    def __call__(self, fn, x_t, t, cond_f, cond_t, x_bar):
        inputs = (x_t, t, cond_f, cond_t, x_bar)
        if not self.engages(x_t):
            return fn(*inputs)
        key = graph_key(inputs)
        step = self._steps.get(key)
        if step is None:
            while len(self._steps) >= MAX_GRAPHS:
                self._steps.popitem(last=False)
            with span("unet.capture") as s:
                step = self._capture(fn, inputs)
                s.add("kernels", sum(step.launches.values()))
            self._steps[key] = step
        else:
            self._steps.move_to_end(key)
        with span("unet.replay"):
            return step.replay(inputs)

    def _capture(self, fn, inputs) -> CapturedStep:
        device = inputs[0].device
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        stream, caller = self._stream, torch.cuda.current_stream(device)
        before = dict(_kernels.LAUNCHES)
        static = tuple(None if t is None else torch.empty_like(t).copy_(t)
                       for t in inputs)
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            fn(*static)
        warm = dict(_kernels.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        # A private pool (the default); other threads may keep using the
        # card while this one captures.
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            output = fn(*static)
        caller.wait_stream(stream)
        launches = {k: _kernels.LAUNCHES[k] - warm[k] for k in warm}
        _kernels.LAUNCHES.update(before)
        return CapturedStep(graph, static, output, launches,
                            groupnorm.scratch(device, stream.cuda_stream))
