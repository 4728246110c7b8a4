"""The trace reader on a made-up trace: busy time as the union of the
device's activities, annotations left out, kernels found inside the
port's ranges by correlation, idle gaps labelled by the host range open
at their start."""

import pytest
import torch

from slambench.trace import summarize

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Ev:
    def __init__(self, name, start, end, dev=CPU, corr=0):
        self._n, self._s, self._e, self._d, self._c = name, start, end, dev, corr

    def device_type(self):
        return self._d

    def is_hidden_event(self):
        return False

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def duration_ns(self):
        return self._e - self._s

    def correlation_id(self):
        return self._c


class Trace:
    def __init__(self, events):
        self._ev = events

    def events(self):
        return self._ev


def test_summary_of_a_made_up_slice():
    ev = [
        Ev("slambench.frame", 0, 1000),
        Ev("slambench.frame", 1000, 2000),
        Ev("slambench.frame", 0, 1000, CUDA),       # the range's mirror
        Ev("klt_track", 100, 200),
        Ev("cudaLaunchKernel", 110, 120, corr=7),
        Ev("klt_track_kernel(KltArgs)", 300, 350, CUDA, corr=7),
        Ev("aten::mul", 340, 500),
        Ev("cudaLaunchKernel", 410, 420, corr=8),
        Ev("elementwise_kernel", 500, 700, CUDA, corr=8),
        Ev("elementwise_kernel", 650, 800, CUDA, corr=9),
        Ev("aten::add", 1500, 1600),
        Ev("elementwise_kernel", 1900, 2000, CUDA, corr=10),
    ]
    s = summarize(Trace(ev))
    assert s["window_s"] == pytest.approx(2000e-9)
    # union: [300, 350) + [500, 800) + [1900, 2000)
    assert s["busy_s"] == pytest.approx(450e-9)
    assert s["activities"] == 4 and s["frames"] == 2
    assert s["kernels"] == {"klt_track": {"calls": 1, "launches": 1,
                                          "device_s": pytest.approx(50e-9)}}
    ops = dict(s["breakdown"]["device_ops"])
    assert ops["elementwise_kernel"] == pytest.approx(450e-9)
    gaps = dict(s["breakdown"]["idle_gaps"])
    # [0, 300) and [800, 1900) start under a frame only, [350, 500) inside
    # aten::mul: a gap takes the innermost range open at its start
    assert gaps == {"slambench.frame": pytest.approx(1400e-9),
                    "aten::mul": pytest.approx(150e-9)}


def test_no_frames_reads_nothing():
    assert summarize(Trace([Ev("k", 0, 5, CUDA)])) is None
