"""Tracing hooks: the port's spans and ``torch.profiler`` traces.

``span(name, **counts)`` times a stage of the host's work where it happens::

    with span("rans.decode", symbols=n) as s:
        ...
        s.add("bytes", len(data))

The outermost span on a thread is a *request*: every span opened inside it,
on that thread, belongs to its record (name, start and end from
``time.perf_counter_ns()``, parent, counts). The newest ``MAX_REQUESTS``
records are kept in memory, each with at most ``MAX_SPANS`` spans; the spans
beyond that are counted as ``dropped``. ``requests()`` reads them,
``total_ms``, ``self_ms``, ``calls`` and ``count`` sum one record's spans by
name, and ``export_spans`` writes records as JSON lines.

With no profiler recording, a span costs two clock reads, a check of the
profiler's flag and a tuple appended to its record: it never synchronizes
the card, so a blocking fetch shows as a span of its own. While a
``torch.profiler`` records, each span also opens a ``record_function`` range
``tpucdc.<name>``, which lays it on the profiler's timeline beside the device
work, and its record is flagged ``profiled``.

``profile_trace`` records a ``torch.profiler`` trace of a region (host and
card) into ``trace.json`` and the requests that ran in it into
``spans.jsonl``, behind the CLI's ``--profile DIR``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import pathlib
import threading
import time

import torch

MAX_REQUESTS = 512
MAX_SPANS = 8192
RANGE_PREFIX = "tpucdc."

_profiler_enabled = torch._C._autograd._profiler_enabled
_clock = time.perf_counter_ns
_local = threading.local()
_ids = itertools.count()
_kept: collections.deque = collections.deque(maxlen=MAX_REQUESTS)
_kept_lock = threading.Lock()


class Request:
    """One request's record. ``spans`` holds a tuple (id, parent id, name,
    start ns, end ns, counts or None) per span in the order the spans
    ended; the root has id 0 and parent None."""

    __slots__ = ("id", "name", "thread", "start_ns", "spans", "dropped",
                 "profiled", "opened")

    def __init__(self, name: str, spans=(), dropped: int = 0,
                 profiled: bool = False, start_ns: int = 0):
        self.id = next(_ids)
        self.name = name
        self.thread = threading.get_ident()
        self.start_ns = start_ns
        self.spans = list(spans)
        self.dropped = dropped
        self.profiled = profiled
        self.opened = len(self.spans)

    def to_json(self) -> dict:
        return {"id": self.id, "name": self.name, "thread": self.thread,
                "profiled": self.profiled, "dropped": self.dropped,
                "spans": [{"id": i, "parent": p, "name": n, "start_ns": a,
                           "end_ns": b, **({"counts": c} if c else {})}
                          for i, p, n, a, b, c in self.spans]}


class span:
    """A timed stage of the host's work; see the module's docstring."""

    __slots__ = ("name", "counts", "_request", "_id", "_parent", "_range",
                 "_t0")

    def __init__(self, name: str, **counts):
        self.name = name
        self.counts = counts

    def add(self, key: str, n) -> None:
        """Add ``n`` to this span's count ``key``."""
        self.counts[key] = self.counts.get(key, 0) + n

    def __enter__(self) -> "span":
        # The profiler's range opens first and closes last, so that it
        # also covers this bookkeeping.
        self._range = None
        if _profiler_enabled():
            self._range = torch.autograd.profiler.record_function(
                RANGE_PREFIX + self.name)
            self._range.__enter__()
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        if stack:
            parent = stack[-1]
            request, self._parent = parent._request, parent._id
        else:
            request, self._parent = Request(self.name), None
        self._request = request
        self._id = request.opened if request.opened < MAX_SPANS else -1
        request.opened += 1
        if self._range is not None:
            request.profiled = True
        stack.append(self)
        self._t0 = t0 = _clock()
        if self._parent is None:
            request.start_ns = t0
        return self

    def __exit__(self, *exc) -> None:
        t1 = _clock()
        stack = _local.stack
        stack.pop()
        request = self._request
        if self._id < 0:
            request.dropped += 1
        else:
            request.spans.append((self._id, self._parent, self.name,
                                  self._t0, t1, self.counts or None))
        if not stack:
            if _profiler_enabled():
                request.profiled = True
            with _kept_lock:
                _kept.append(request)
        if self._range is not None:
            self._range.__exit__(None, None, None)


def requests() -> list:
    """The kept records, oldest first."""
    with _kept_lock:
        return list(_kept)


def total_ms(record: Request, name: str) -> float:
    """Milliseconds of all of a record's spans called ``name``."""
    return 1e-6 * sum(b - a for _, _, n, a, b, _ in record.spans
                      if n == name)


def self_ms(record: Request, name: str) -> float:
    """``total_ms`` less the time their child spans cover (the children of
    a span run one after another on its thread)."""
    ids = {i for i, _, n, _, _, _ in record.spans if n == name}
    covered = sum(b - a for _, p, _, a, b, _ in record.spans if p in ids)
    return total_ms(record, name) - 1e-6 * covered


def calls(record: Request, name: str) -> int:
    """How many of a record's spans are called ``name``."""
    return sum(1 for s in record.spans if s[2] == name)


def count(record: Request, name: str, key: str):
    """The sum of count ``key`` over a record's spans called ``name``."""
    return sum(c.get(key, 0) for _, _, n, _, _, c in record.spans
               if n == name and c)


def export_spans(path, records=None) -> None:
    """Write ``records`` (all the kept ones by default) to ``path``, one
    JSON object a record."""
    with open(path, "w") as f:
        for r in requests() if records is None else records:
            f.write(json.dumps(r.to_json()) + "\n")


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """Profile the region into ``logdir/trace.json`` and write the requests
    that started in it to ``logdir/spans.jsonl`` when ``logdir`` is set;
    nothing otherwise. The card's activity is recorded where there is
    one."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = pathlib.Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    start = _clock()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(path / "trace.json"))
    export_spans(path / "spans.jsonl",
                 [r for r in requests() if r.start_ns >= start])
