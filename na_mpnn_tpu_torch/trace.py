"""Spans of the program's stages: named intervals on the host clock.

    from na_mpnn_tpu_torch import trace
    trace.enable()
    ...                                   # run the CLI, a training step
    for r in trace.records():
        print(r.name, r.t1 - r.t0, r.counts)

``span(name, **counts)`` marks a stage (``cli.parse``, ``sample.decode``,
``train.backward``, ``kernel.<launch>``); ``counts`` are small integers
known on the host from shapes (the encoder's rows, the decode loop's
steps), never a value that would wait for the device. A stage that counts
its work as it goes (``cli.pdbs``: the files written, the templates
built) opens the span with those counts at 0 and calls ``add`` on what
the ``with`` gives. No span synchronises the device, so a span's time is
host time: where the device sets the pace, the stage that waits for it (a
copy to the host) holds the wait.

A record (``Record``) holds its ``name``, ``t0`` and ``t1``
(``time.perf_counter``), its ``request`` and its ``counts``. A span opened
while no span is open anywhere starts a request, with an id of its own;
every span opened while it is open takes that id, those on other threads
too (autograd's backward thread). So the stages of one CLI call
(``cli_entry``) or one training step share an id; a caller of the CLI's
``main`` has no ``cli.call`` around it and gets a request per stage.
Records stay in memory, the newest ``MAX_RECORDS``, as plain tuples that
the garbage collector does not walk, until ``clear()``.

The tracer is off until ``enable()``. While ``torch.profiler`` records, a
span also enters ``record_function(name)`` whether or not the tracer is
on, so the stage is named in the profiler's trace. Off and outside a
profile, a span costs two flag checks and returns a shared no-op context.
The flag and the buffer are the module's global state.
"""
from __future__ import annotations

import collections
import itertools
import time

import torch

MAX_RECORDS = 1 << 20

Record = collections.namedtuple("Record", "name t0 t1 request counts")

_enabled = False
_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_ids = itertools.count(1)
_root = None               # the open span that started the current request
_profiling = torch._C._autograd._profiler_enabled


class Span:
    """An open span; on closing it appends its record."""

    __slots__ = ("name", "counts", "t0", "request", "_annotation", "_keep")

    def __init__(self, name, counts, keep):
        self.name = name
        self.counts = counts
        self._keep = keep
        self._annotation = None

    def __enter__(self):
        global _root
        if _profiling():
            self._annotation = torch.profiler.record_function(self.name)
            self._annotation.__enter__()
        if self._keep:
            if _root is None:
                self.request = next(_ids)
                _root = self
            else:
                self.request = _root.request
            self.t0 = time.perf_counter()
        return self

    def add(self, **counts):
        """Add ``counts`` to the span's counts."""
        for k, n in counts.items():
            self.counts[k] = self.counts.get(k, 0) + n

    def __exit__(self, *exc):
        global _root
        if self._keep:
            t1 = time.perf_counter()
            if _root is self:
                _root = None
            _records.append((self.name, self.t0, t1, self.request,
                             tuple(self.counts.items())))
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        return False


class _Off:
    """The shared no-op span of a tracer that is off outside a profile."""

    def __enter__(self):
        return self

    def add(self, **counts):
        pass

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, **counts):
    """A context manager that marks the stage ``name`` (see the module's
    docstring)."""
    if _enabled:
        return Span(name, counts, True)
    if _profiling():
        return Span(name, counts, False)
    return _OFF


def enable():
    """Record spans from now on."""
    global _enabled
    _enabled = True


def disable():
    """Stop recording (what was recorded stays)."""
    global _enabled
    _enabled = False


def records() -> list:
    """The records of the closed spans held, in the order they closed."""
    return [Record(*r[:4], dict(r[4])) for r in _records]


def clear():
    _records.clear()
