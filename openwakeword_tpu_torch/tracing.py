"""Spans at the port's layer boundaries, on the profiler's clock.

``span(name)`` opens a ``torch.profiler.record_function`` range named
``oww/<name>`` while a ``torch.profiler`` profile records, and nothing
otherwise. The ranges go into the profiler's own trace, beside the device's
operations, so a device operation launched inside one is attributed to it
(its runtime call's parents hold the range) and an idle stretch of the
device can be put down to what the host was doing. Export them with the
profiler's ``export_chrome_trace``; the port keeps no record of its own.

There is no switch: running ``torch.profiler`` turns the spans on. The
check is the profiler's process-wide flag, read on every thread (a
profiler started with ``profile_all_threads`` records the server's fetcher
thread too). A span never synchronizes the device and never reads a device
value.
"""

import contextlib

import torch
from torch.autograd import profiler as _profiler

PREFIX = "oww/"

_OFF = contextlib.nullcontext()


def span(name: str, args=None):
    """A ``record_function`` range named ``oww/<name>`` while a profiler
    records, with ``args`` (such as a tick's frame index) as its string
    argument; one shared no-op context otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(PREFIX + name, None if args is None else str(args))
