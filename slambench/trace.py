"""Reading a torch.profiler trace of the profiled slice of a window.

Read from the profiler's raw events (``kineto_results``): the
FunctionEvent tree and ``key_averages`` take tens of seconds over the
~10^5 events of a few frames. The host ranges read are the benchmark's
``slambench.frame`` (one ``process_frame`` call) and every
``record_function`` range of the port (today ``build_pyramid``,
``klt_track``, ``ncc_blocks``, ``ncc_search``), found by name.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch

FRAME_RANGE = "slambench.frame"


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _user_range(name: str) -> bool:
    """A ``record_function`` range, not an operator or a profiler step."""
    return not (name.startswith("aten::") or name.startswith("ProfilerStep")
                or name == FRAME_RANGE)


def summarize(kineto_results) -> dict | None:
    """The slice's device busy and window seconds, device activities, each
    port range's kernel launches and their device time, the top device
    operations and the idle gaps summed by the innermost host range or
    operator open at each gap's start. None when the trace holds no frame
    or no device activity."""
    cuda = torch.autograd.DeviceType.CUDA
    device, runtime = [], []
    ranges = defaultdict(list)
    for e in kineto_results.events():
        if e.device_type() == cuda:
            if not e.is_hidden_event():
                device.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                               e.name(), e.correlation_id()))
        elif e.name().startswith("cu"):
            runtime.append((e.start_ns(), e.correlation_id()))
        else:
            ranges[e.name()].append((e.start_ns(), e.end_ns()))
    # a host range's mirror on the device timeline spans the whole range:
    # an annotation, no device work
    acts = [a for a in device if a[2] not in ranges]
    frames = sorted(ranges.get(FRAME_RANGE, []))
    if not frames or not acts:
        return None
    t0 = frames[0][0]
    t1 = max(frames[-1][1], max(a[1] for a in acts))
    acts = [a for a in acts if a[1] > t0 and a[0] < t1]
    busy = _union((max(a[0], t0), min(a[1], t1)) for a in acts)
    by_op = defaultdict(float)
    for a in acts:
        by_op[a[2][:100]] += (a[1] - a[0]) / 1e9
    spans = sorted((s, e, name) for name, sp in ranges.items()
                   for s, e in sp)
    span_starts = [sp[0] for sp in spans]
    gaps = []
    prev_end = t0
    for s, e in busy + [[t1, t1]]:
        if s > prev_end:
            gaps.append((prev_end, s))
        prev_end = max(prev_end, e)
    by_gap = defaultdict(float)
    for gs, ge in gaps:
        label = "outside any range"
        i = bisect.bisect_right(span_starts, gs) - 1
        for s, e, name in spans[max(0, i - 256):i + 1][::-1]:
            if e > gs:
                label = name
                break
        by_gap[label.split("#")[0]] += (ge - gs) / 1e9
    runtime.sort()
    starts = [r[0] for r in runtime]
    on_device = defaultdict(list)
    for a in acts:
        on_device[a[3]].append(a)
    kernels = {}
    for name, sp in ranges.items():
        if not _user_range(name):
            continue
        own = [a for s, e in sp
               for _, corr in runtime[bisect.bisect_left(starts, s):
                                      bisect.bisect_right(starts, e)]
               for a in on_device.get(corr, []) if name in a[2]]
        if own:
            kernels[name] = {"calls": len(sp), "launches": len(own),
                             "device_s": sum(a[1] - a[0] for a in own) / 1e9}
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    longest = sorted(by_gap.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (t1 - t0) / 1e9,
            "busy_s": sum(e - s for s, e in busy) / 1e9,
            "activities": len(acts), "frames": len(frames),
            "kernels": kernels,
            "breakdown": {"device_ops": [[k, v] for k, v in top],
                          "idle_gaps": [[k, v] for k, v in longest]}}
