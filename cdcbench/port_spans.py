"""The port's own spans (``tpucdc_torch.utils.profiling``), read in the
run's process after the window.

A cell's requests are the kept records whose root is its entry point
(``codec.decompress``, ``codec.compress`` or ``train.chunk``); a record
flagged as profiled (the traced slice) is left out. A metric is the median
over those requests of a per-request sum: milliseconds or a count of the
named spans, divided by the chunk's ``steps`` for a training chunk. The
median, as the set-up's warm-up requests share the port's ring of records
with the window's.

Each reader returns None where the port keeps no such records or no
request has such a span (a port without spans, or a renamed stage): the
metric is then left out of the result, not read as 0.
"""

from __future__ import annotations

import statistics


def _port():
    """The port's recorder, or None where the port has none."""
    try:
        from tpucdc_torch.utils import profiling
    except ImportError:
        return None
    if not all(hasattr(profiling, f) for f in ("requests", "total_ms",
                                                "calls", "count")):
        return None
    return profiling


def _median(root: str, value, names, per_step: bool, records):
    """The median of ``value(profiling, record)`` over the unprofiled
    records of ``root``; None unless one of them holds a span in
    ``names``."""
    p = _port()
    if p is None:
        return None
    if records is None:
        records = p.requests()
    mine = [r for r in records if r.name == root and not r.profiled]
    if not any(p.calls(r, n) for r in mine for n in names):
        return None
    values = []
    for r in mine:
        v = value(p, r)
        if per_step:
            v /= p.count(r, root, "steps")
        values.append(v)
    return statistics.median(values)


def ms(root: str, *names: str, per_step: bool = False, records=None):
    """Median host ms a request (or a training step) spends in the spans
    ``names``, summed."""
    return _median(root, lambda p, r: sum(p.total_ms(r, n) for n in names),
                   names, per_step, records)


def calls(root: str, name: str, per_step: bool = False, records=None):
    """Median number of spans ``name`` a request (or a step) holds."""
    return _median(root, lambda p, r: p.calls(r, name), (name,), per_step,
                   records)
