"""The benchmark's spans: host timers that ``cdcbench`` puts around runtime
methods of the port in traced runs only. They are listed here, in one place,
so that a method the port renames shows as a missing span (and so a missing
metric), not as a wrong one.

Each span is also a ``torch.profiler.record_function`` range named
``cdcbench.<span>``, so the trace puts idle gaps down to it.
"""

from __future__ import annotations

import collections
import functools
import time

# span name → the ``CodecRuntime`` method it times
RUNTIME_SPANS = {
    "decode_symbols": "_decode_symbols",   # bitstream → ŷ symbols and μ
    "gamma_search": "_optimize_gamma",     # the encode's γ search
}


class Spans:
    """Host seconds of every call of each span, in call order."""

    def __init__(self):
        self.seconds = collections.defaultdict(list)

    def wrap(self, name: str, fn):
        import torch

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            with torch.profiler.record_function(f"cdcbench.{name}"):
                out = fn(*args, **kwargs)
            self.seconds[name].append(time.perf_counter() - t0)
            return out
        return timed

    def install(self, runtime) -> None:
        """Shadow each listed method on this runtime object (the class is
        left as it is). A method the runtime lacks gets no span, and the
        metrics that read it are left out of the result."""
        for name, method in RUNTIME_SPANS.items():
            bound = getattr(runtime, method, None)
            if bound is not None:
                setattr(runtime, method, self.wrap(name, bound))
