"""The benchmark's readers of the program's spans on made-up inputs: the
span table of a profiled slice (``slambench/span_trace.py``) and the
per-layer metrics that read the program's own per-call rows."""

import sys
import types

import pytest

from coslam_torch.spans import Row
from slambench.run import load_module
from slambench.span_trace import OUTSIDE, summarize_spans
from slambench.tests.test_slambench_trace import CUDA, Ev, Trace
from slambench.trace import summarize


class Range(Ev):
    """A user annotation (a ``record_function`` range)."""

    def is_user_annotation(self):
        return True


class Op(Ev):
    """An operator, a runtime call or a profiler's own range."""

    def is_user_annotation(self):
        return False


def made_up_slice():
    """One frame: a step whose idle gap opens after 400 operator ranges,
    a kernel range inside it, and a cadence with a wait."""
    ev = [
        Range("slambench.frame", 0, 10000),
        Range("ProfilerStep#3", 0, 10000),
        Range("engine.frame", 10, 9990),
        Ev("engine.frame", 10, 9990, CUDA),          # the range's mirror
        Range("engine.step", 20, 5000),
        Op("cudaLaunchKernel", 30, 35, corr=1),
        Ev("elementwise_kernel", 100, 200, CUDA, corr=1),
        Range("klt_track", 40, 60),
        Op("cudaLaunchKernel", 45, 50, corr=2),
        Ev("klt_track_kernel(KltArgs)", 200, 300, CUDA, corr=2),
        Op("cudaLaunchKernel", 3100, 3105, corr=3),
        Ev("reduce_kernel", 3500, 3600, CUDA, corr=3),
        Range("engine.cadence", 5000, 9900),
        Range("engine.wait.stats", 5100, 5200),
        Op("Activity Buffer Request", 5300, 5400),
        Op("cudaLaunchKernel", 6000, 6005, corr=4),
        Ev("elementwise_kernel", 6100, 6200, CUDA, corr=4),
    ]
    ev += [Op("aten::mul", 1000 + 5 * i, 1002 + 5 * i) for i in range(400)]
    return Trace(ev)


def test_span_table_of_a_made_up_slice():
    s = summarize_spans(made_up_slice())
    assert s["frames"] == 1 and s["window_s"] == pytest.approx(10000e-9)
    # gaps [0, 100) [300, 3500) [3600, 6100) [6200, 10000)
    assert s["idle_s"] == pytest.approx(9600e-9)
    assert s[OUTSIDE] == pytest.approx(100e-9)
    t = s["spans"]
    assert set(t) == {"engine.frame", "engine.step", "klt_track",
                      "engine.cadence", "engine.wait.stats"}
    want = {  # calls, launches, device ns, idle ns
        "engine.frame": (1, 4, 400, 0),
        "engine.step": (1, 3, 300, 3200 + 2500),
        "klt_track": (1, 1, 100, 0),
        "engine.cadence": (1, 1, 100, 3800),
        "engine.wait.stats": (1, 0, 0, 0)}
    for name, (calls, launches, dev, idle) in want.items():
        assert t[name]["calls"] == calls, name
        assert t[name]["launches"] == launches, name
        assert t[name]["device_s"] == pytest.approx(dev * 1e-9), name
        assert t[name]["idle_s"] == pytest.approx(idle * 1e-9), name


def test_the_existing_reader_reads_as_before():
    """The slice's summary keeps its keys and values: no span enters
    ``kernels``, and the gap that opens 400 ranges after its step began
    still reads "outside any range" there (its 256-range lookback)."""
    s = summarize(made_up_slice())
    assert s["kernels"] == {"klt_track": {"calls": 1, "launches": 1,
                                          "device_s": pytest.approx(100e-9)}}
    assert s["activities"] == 4 and s["frames"] == 1
    assert dict(s["breakdown"]["idle_gaps"]) == {
        "slambench.frame": pytest.approx(100e-9),
        "engine.step": pytest.approx(3200e-9),
        "outside any range": pytest.approx(2500e-9),
        "engine.cadence": pytest.approx(3800e-9)}


def test_no_frames_reads_nothing():
    assert summarize_spans(Trace([Ev("k", 0, 5, CUDA)])) is None


def row(calls, host, own=None):
    return [calls, host, host if own is None else own]


# one window frame of the live path with a BA
TABLE = {
    "engine.frame": row(1, 0.3, 0.01),
    "engine.step": row(1, 0.1, 0.02),
    "engine.cadence": row(1, 0.15, 0.005),
    "engine.poll_ba": row(1, 0.0001),
    "engine.grouping": row(1, 0.002),
    "engine.intercam": row(1, 0.03, 0.001),
    "engine.intercam_map": row(1, 0.02, 0.015),
    "engine.register": row(1, 0.009),
    "engine.kf_ready": row(1, 0.003, 0.002),
    "engine.keyframe": row(1, 0.0006),
    "engine.wait.stats": row(1, 0.004),
    "engine.wait.kf_pose": row(1, 0.0009),
    "ba.run": row(1, 0.2, 0.0001),
    "ba.solve": row(1, 0.15, 0.03),
    "ncc_blocks": row(2, 0.005),
}
NO_BA = {k: v for k, v in TABLE.items() if not k.startswith("ba.")}
LIVE = {"warm_frames": 3, "engine": {"chunk": 1}}


def rows(tables, traced=()):
    """Rows of ``engine.frame`` for the made-up program: one a call, the
    calls in ``traced`` closed under the profiler."""
    return [Row("engine.frame", i, i in traced, i, t)
            for i, t in enumerate(tables)]


@pytest.fixture
def program(monkeypatch):
    """A stand-in for the program's span module, holding ``rows``."""
    mod = types.SimpleNamespace(rows=[])
    mod.history = lambda: list(mod.rows)
    monkeypatch.setitem(sys.modules, "coslam_torch.spans", mod)
    return mod


def read(metric, traffic=LIVE):
    return load_module("metrics", metric).read({"traffic": traffic})


def test_span_metrics_of_a_made_up_window(program):
    # 3 set-up calls (a costly first BA), then 10 window calls, 3 with a BA
    setup = [{"ba.run": row(1, 9.0), "engine.frame": row(1, 9.0)}] * 3
    program.rows = rows(setup + [TABLE] * 3 + [NO_BA] * 7)
    assert read("ba.ms_per_run") == pytest.approx(200.0)
    own = 0.005 + 0.0001 + 0.002 + 0.001 + 0.015 + 0.009 + 0.002 + 0.0006
    assert read("engine.cadence_ms_per_frame") == pytest.approx(
        1e3 * own)
    assert read("engine.wait_ms_per_frame") == pytest.approx(
        1e3 * 0.0049)


def test_the_profiled_slice_and_its_warm_up_are_left_out(program):
    """Survey: the slice is the traced calls and the chunk's calls before
    them (the profiler's warm-up steps), as the stage clock leaves them."""
    survey = {"warm_frames": 2, "engine": {"chunk": 3}}
    slow = {k: row(v[0], 100 * v[1], 100 * v[2]) for k, v in TABLE.items()}
    tables = [slow] * 2 + [TABLE] * 4 + [slow] * 3 + [slow] * 6 + [NO_BA]
    program.rows = rows(tables, traced=range(9, 15))
    assert read("ba.ms_per_run", survey) == pytest.approx(200.0)
    assert read("engine.wait_ms_per_frame", survey) == pytest.approx(
        1e3 * 0.0049)


def test_no_ba_in_the_window_reads_none(program):
    program.rows = rows([TABLE] * 3 + [NO_BA] * 10)
    assert read("ba.ms_per_run") is None
    assert read("engine.wait_ms_per_frame") == pytest.approx(4.9)


@pytest.mark.parametrize("metric", ["ba.ms_per_run",
                                    "engine.cadence_ms_per_frame",
                                    "engine.wait_ms_per_frame"])
def test_a_program_without_spans_reads_none(metric, program, monkeypatch):
    program.rows = []
    assert read(metric) is None
    # the window's first calls no longer in the history
    program.rows = rows([TABLE] * 20)[5:]
    assert read(metric) is None
    monkeypatch.delitem(sys.modules, "coslam_torch.spans")
    assert read(metric) is None


def test_the_window_of_a_tiny_run():
    """The readers find the window's calls in the program's history after
    a run of the tiny cell on the CPU: the warm frames left out."""
    from coslam_torch import spans
    from slambench.metrics._spans import window
    from slambench.run import run_cell
    from slambench.tests.tiny import cell
    c = cell("live", frames=24, warm=10)
    spans.reset()
    run_cell(c, 2 ** 33 + 5, 0.0, True, device="cpu", max_frames=12)
    table, frames = window({"traffic": c["traffic"]})
    assert frames == 12
    assert table["engine.frame"][0] == 12
    assert table["engine.step"][0] == 12
    assert 0 < read("engine.cadence_ms_per_frame", c["traffic"])
    assert 0 < read("engine.wait_ms_per_frame", c["traffic"])
