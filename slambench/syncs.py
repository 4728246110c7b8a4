"""Synchronizing calls of the program (a frozen copy of chip_smoke.py's
``SyncCounter``, without its count inside ``frame_step``)."""

from __future__ import annotations

import collections
import sys
import warnings

import torch

PROGRAM = "coslam_torch"


class SyncCounter:
    """Counts the synchronizing CUDA calls made while it is entered, under
    ``torch.cuda.set_sync_debug_mode("warn")`` (a blocking copy, a stream
    or event sync), and apart the program's own calls of
    ``torch.cuda.synchronize()``, which the debug mode does not report;
    the benchmark's own are not counted. ``sites`` counts them by the
    program's innermost function on the stack (module:function:line)."""

    def __init__(self):
        self.total = 0
        self.explicit_syncs = 0
        self.sites = collections.Counter()

    def _synchronize(self, device=None):
        caller = sys._getframe(1).f_globals.get("__name__", "")
        if caller.startswith(PROGRAM):
            self.explicit_syncs += 1
        return self._sync(device)

    def _seen(self, message, *args, **kw):
        if "synchronizing CUDA operation" not in str(message):
            return
        self.total += 1
        f = sys._getframe()
        while f is not None:
            name = f.f_globals.get("__name__", "")
            if name.startswith(PROGRAM):
                self.sites[f"{name}:{f.f_code.co_name}:{f.f_lineno}"] += 1
                return
            f = f.f_back

    def __enter__(self):
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = self._seen
        torch.cuda.set_sync_debug_mode("warn")
        self._sync = torch.cuda.synchronize
        torch.cuda.synchronize = self._synchronize
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize = self._sync
        torch.cuda.set_sync_debug_mode(0)
        self._warnings.__exit__(*exc)
