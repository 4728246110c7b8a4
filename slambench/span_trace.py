"""The program's spans in a profiled slice: where the slice's device work
was launched from, and where its idle gaps opened.

``summarize_spans`` reads the same raw events as ``trace.summarize`` and
is meant to join it as its ``spans`` key (PERF.md section 7): for every
program span (a user annotation, as ``coslam_torch.spans`` opens under a
recording profiler, other than the benchmark's own ``slambench.*`` and
the profiler's steps) its calls, the device activities whose launching
runtime call lies inside one of its intervals (children included), their
device seconds, and the idle seconds of the gaps whose innermost open
program span at the gap's start it is. The search for that span runs
over the program's spans only, with no lookback cap; gaps that open
between them read ``outside any span``.
"""

from __future__ import annotations

import bisect
import collections

import torch

from slambench.trace import FRAME_RANGE, _union

OUTSIDE = "outside any span"


def summarize_spans(kineto_results) -> dict | None:
    """The slice's table by program span (module docstring), with the
    slice's frames, window and idle seconds. None when the trace holds no
    frame or no device activity."""
    cuda = torch.autograd.DeviceType.CUDA
    device, runtime = [], []
    ranges = collections.defaultdict(list)
    program = set()
    for e in kineto_results.events():
        if e.device_type() == cuda:
            if not e.is_hidden_event():
                device.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                               e.name(), e.correlation_id()))
        elif e.name().startswith("cu"):
            runtime.append((e.start_ns(), e.correlation_id()))
        else:
            ranges[e.name()].append((e.start_ns(), e.end_ns()))
            if e.is_user_annotation() and not e.name().startswith(
                    ("slambench.", "ProfilerStep")):
                program.add(e.name())
    acts = [a for a in device if a[2] not in ranges]
    frames = sorted(ranges.get(FRAME_RANGE, []))
    if not frames or not acts:
        return None
    t0 = frames[0][0]
    t1 = max(frames[-1][1], max(a[1] for a in acts))
    acts = [a for a in acts if a[1] > t0 and a[0] < t1]
    busy = _union((max(a[0], t0), min(a[1], t1)) for a in acts)
    gaps, prev_end = [], t0
    for s, e in busy + [[t1, t1]]:
        if s > prev_end:
            gaps.append((prev_end, s))
        prev_end = max(prev_end, e)
    spans = {name: ranges[name] for name in program}
    runtime.sort()
    starts = [r[0] for r in runtime]
    on_device = collections.defaultdict(list)
    for a in acts:
        on_device[a[3]].append(a)
    table = {}
    for name, sp in spans.items():
        own = [a for s, e in _union(sp)
               for _, corr in runtime[bisect.bisect_left(starts, s):
                                      bisect.bisect_right(starts, e)]
               for a in on_device.get(corr, [])]
        table[name] = {"calls": len(sp), "launches": len(own),
                       "device_s": sum(a[1] - a[0] for a in own) / 1e9,
                       "idle_s": 0.0}
    # the innermost open span at a gap's start is the latest-starting
    # interval that contains it (spans nest: one thread opens them)
    intervals = sorted((s, e, name) for name, sp in spans.items()
                       for s, e in sp)
    interval_starts = [iv[0] for iv in intervals]
    outside = 0.0
    for gs, ge in gaps:
        i = bisect.bisect_right(interval_starts, gs) - 1
        while i >= 0 and intervals[i][1] <= gs:
            i -= 1
        if i < 0:
            outside += (ge - gs) / 1e9
        else:
            table[intervals[i][2]]["idle_s"] += (ge - gs) / 1e9
    return {"frames": len(frames), "window_s": (t1 - t0) / 1e9,
            "idle_s": sum(ge - gs for gs, ge in gaps) / 1e9,
            OUTSIDE: outside, "spans": table}
