"""Named spans of the port: the engine's stages, the fused step's stages,
the BA, the host's waits on the card and the kernel wrappers, on one
clock.

    with span("engine.step", frame=f) as s:
        ...
    s.seconds            # the span's wall seconds, once closed

    @span("ba.solve")
    def solve(...):
        ...

Each closed span adds to a process-level table under its name (the way
``ops.launch_counts()`` is process-level): one call, its wall seconds
(``host_s``) and the part of them that no span opened inside it covers
(``self_s``). Spans nest on one stack: they are opened and closed by the
thread that drives the engine.

An outermost span (the engine's ``engine.frame``, one a
``process_frame`` call) also closes a row of ``history()``: its name,
frame and ordinal, whether a profiler recorded it, and the table of the
spans it held. The last ``HISTORY`` rows are kept, so that a reader can
sum the calls it wants (those past a warm-up, those outside a profiled
slice).

While a torch profiler records, a span also opens a ``record_function``
range of its name (a user annotation, with the frame number as its
argument, which a profiler with ``record_shapes=True`` keeps), so the
profiler's trace places it on the clock of the device activities. While
no profiler records, a span makes no dispatcher call: two clock reads and
two table updates.
"""

from __future__ import annotations

import collections
import functools
from time import perf_counter
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

HISTORY = 1024           # rows of outermost spans kept


class Row(NamedTuple):
    """One closed outermost span: ``n`` rows of its name closed before it
    (since the last ``reset``), and ``table``, {name: [calls, host_s,
    self_s]} of itself and every span it held."""
    name: str
    frame: Optional[int]
    traced: bool
    n: int
    table: dict


_TABLE: dict = {}        # name -> [calls, host_s, self_s]
_STACK: list = []        # the open spans, innermost last
_ROWS: collections.deque = collections.deque(maxlen=HISTORY)
_ROWS_OF: collections.Counter = collections.Counter()


def _add(table: dict, name: str, dt: float, self_s: float) -> None:
    row = table.get(name)
    if row is None:
        table[name] = [1, dt, self_s]
    else:
        row[0] += 1
        row[1] += dt
        row[2] += self_s


class span:
    """A named span (module docstring): a context manager, or a decorator
    that opens the span around each call."""

    __slots__ = ("name", "frame", "seconds", "_t0", "_child", "_range",
                 "_rows")

    def __init__(self, name: str, frame=None):
        self.name = name
        self.frame = frame
        self.seconds = 0.0

    def __enter__(self):
        self._range = None
        if _profiler._is_profiler_enabled:
            args = () if self.frame is None else (int(self.frame),)
            self._range = torch.autograd._record_function_with_args_enter(
                self.name, *args)
        self._rows = None if _STACK else {}
        self._child = 0.0
        _STACK.append(self)
        self._t0 = perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = self.seconds = perf_counter() - self._t0
        _STACK.pop()
        self_s = dt - self._child
        _add(_TABLE, self.name, dt, self_s)
        if _STACK:
            _STACK[-1]._child += dt
            _add(_STACK[0]._rows, self.name, dt, self_s)
        else:
            _add(self._rows, self.name, dt, self_s)
            frame = None if self.frame is None else int(self.frame)
            _ROWS.append(Row(self.name, frame, self._range is not None,
                             _ROWS_OF[self.name], self._rows))
            _ROWS_OF[self.name] += 1
        if self._range is not None:
            torch.autograd._record_function_with_args_exit(self._range)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return wrapped


def snapshot() -> dict:
    """{name: {"calls", "host_s", "self_s"}} of the spans closed since the
    last ``reset``."""
    return {name: {"calls": c, "host_s": h, "self_s": s}
            for name, (c, h, s) in _TABLE.items()}


def history() -> list:
    """The last ``HISTORY`` rows (``Row``) of outermost spans closed since
    the last ``reset``, oldest first."""
    return list(_ROWS)


def reset() -> None:
    """Empty the table and the history."""
    _TABLE.clear()
    _ROWS.clear()
    _ROWS_OF.clear()

