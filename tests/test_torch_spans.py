"""The port's spans (``coslam_torch/spans.py``): nesting and self time,
no dispatcher call while no profiler records, ranges under a recording
profiler, and the engine's stage clock fed by its stages' spans on the
benchmark's tiny cell."""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from coslam_torch import spans
from coslam_torch.spans import span


def _open():
    """The names of the open spans, outermost first."""
    return [s.name for s in spans._STACK]


@pytest.fixture(autouse=True)
def _fresh_table():
    spans.reset()
    yield
    spans.reset()


def test_nesting_and_self_time(monkeypatch):
    """Host time is the span's duration, self time that less the part its
    child spans cover; each outermost span closes a row of the history."""
    ticks = iter([0.0, 1.0, 3.0, 4.0, 4.5, 10.0, 20.0, 21.0])
    monkeypatch.setattr(spans, "perf_counter", lambda: next(ticks))
    with span("outer", 5) as outer:                    # 0 .. 10
        with span("inner"):                            # 1 .. 3
            pass
        with span("inner"):                            # 4 .. 4.5
            assert _open() == ["outer", "inner"]
    with span("outer"):                                # 20 .. 21
        pass
    assert outer.seconds == 10.0
    assert _open() == []
    assert spans.snapshot() == {
        "inner": {"calls": 2, "host_s": 2.5, "self_s": 2.5},
        "outer": {"calls": 2, "host_s": 11.0, "self_s": 8.5}}
    first, second = spans.history()
    assert (first.name, first.frame, first.traced, first.n) == \
        ("outer", 5, False, 0)
    assert first.table == {"inner": [2, 2.5, 2.5], "outer": [1, 10.0, 7.5]}
    assert (second.frame, second.n, second.table) == \
        (None, 1, {"outer": [1, 1.0, 1.0]})


def test_history_keeps_the_last_rows(monkeypatch):
    monkeypatch.setattr(spans, "_ROWS",
                        spans.collections.deque(maxlen=3))
    for f in range(5):
        with span("engine.frame", f):
            with span("step.track"):
                pass
    rows = spans.history()
    assert [(r.frame, r.n) for r in rows] == [(2, 2), (3, 3), (4, 4)]
    assert spans.snapshot()["engine.frame"]["calls"] == 5
    spans.reset()
    assert spans.history() == [] and spans.snapshot() == {}
    with span("engine.frame", 9):
        pass
    assert spans.history()[0].n == 0


def test_decorator_and_sync_at_the_end(monkeypatch):
    ticks = iter([0.0, 2.0])
    monkeypatch.setattr(spans, "perf_counter", lambda: next(ticks))
    seen = []

    @span("work")
    def work(x):
        seen.append(_open())
        return 2 * x

    assert work(3) == 6 and work.__name__ == "work"
    assert seen == [["work"]]
    # the engine's stage: the sync (profile=True) runs inside the span, and
    # the span's seconds go to the stage clock
    from coslam_torch.slam.pipeline import CoSlamEngine
    synced = []
    eng = types.SimpleNamespace(frame=4, timing={"upload": 1.0},
                                _sync=lambda: synced.append(
                                    _open()))
    ticks2 = iter([5.0, 6.5, 7.0, 7.25])
    monkeypatch.setattr(spans, "perf_counter", lambda: next(ticks2))
    with CoSlamEngine._stage(eng, "engine.upload", "upload"):
        pass
    with CoSlamEngine._stage(eng, "engine.wait.stats"):
        pass
    assert synced == [["engine.upload"]]
    assert eng.timing == {"upload": 2.5}
    assert spans.snapshot()["engine.upload"]["host_s"] == 1.5
    assert spans.history()[-1].frame == 4


def test_exception_closes_the_span():
    with pytest.raises(ValueError):
        with span("outer"):
            with span("inner"):
                raise ValueError("x")
    assert _open() == []
    assert {k: v["calls"] for k, v in spans.snapshot().items()} == \
        {"outer": 1, "inner": 1}


def test_no_dispatcher_call_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range was opened")
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        refuse)
    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter",
                        refuse)
    with pytest.raises(AssertionError):
        with torch.profiler.record_function("probe"):
            pass
    with span("engine.frame", 3):
        with span("step.track"):
            pass
    assert spans.snapshot()["engine.frame"]["calls"] == 1


def test_ranges_under_a_profiler_carry_names_and_frames():
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        with span("engine.frame", 7):
            with span("step.track"):
                torch.ones(3).add_(1)
    ev = {e.name(): e for e in p.profiler.kineto_results.events()}
    assert ev["engine.frame"].concrete_inputs() == [7]
    assert ev["step.track"].concrete_inputs() == []
    assert ev["engine.frame"].start_ns() <= ev["step.track"].start_ns() \
        <= ev["step.track"].end_ns() <= ev["engine.frame"].end_ns()
    assert ev["aten::add_"].start_ns() >= ev["step.track"].start_ns()
    # a row closed under the profiler says so
    with span("engine.frame", 8):
        pass
    assert [(r.frame, r.traced) for r in spans.history()] == \
        [(7, True), (8, False)]


# the spans each tiny-cell path reaches in frames 10..29, and the stage
# clock's keys there (those of the engine before the spans, and of the
# JAX engine: tests/torch_parity.py holds the two equal)
STAGES = {"engine.frame", "engine.upload", "engine.step", "engine.cadence",
          "engine.grouping", "engine.merge", "engine.loop",
          "engine.intercam", "engine.intercam_map", "engine.register",
          "engine.kf_ready", "engine.keyframe", "step.pyramid",
          "step.track", "step.pose_update", "step.classify",
          "step.new_points", "step.lifecycle", "step.stats", "ba.run",
          "ba.build_table", "ba.solve", "ba.normal_terms", "ba.schur_solve",
          "ba.apply", "engine.wait.stats", "engine.wait.kf_pose",
          "engine.wait.prefetch_poses", "engine.wait.intercam_count",
          "engine.wait.intercam_upload",
          "build_pyramid", "klt_track", "ncc_blocks"}
CADENCE_KEYS = {"ba", "cad_addkf", "cad_grouping", "cad_icmap",
                "cad_intercam", "cad_kfready", "cad_loop", "cad_merge",
                "cad_register", "upload"}
PATHS = {
    "live": (STAGES | {"engine.poll_ba", "engine.wait.host_scan"},
             CADENCE_KEYS | {"core_fused", "poll_ba", "stats_wait"},
             "core_fused"),
    "survey": (STAGES | {"engine.copy_async"},
               CADENCE_KEYS | {"core_chunk", "copy_async", "cadence_total"},
               "core_chunk"),
}


@pytest.mark.parametrize("traffic", sorted(PATHS))
def test_engine_stages_feed_the_stage_clock(traffic):
    from coslam_torch.slam.pipeline import CoSlamEngine
    from slambench.run import program_config
    from slambench.scene import intrinsics, render_scene
    from slambench.tests.tiny import cell
    c = cell(traffic, frames=30, warm=10)
    cfg, tr = c["config"], c["traffic"]
    frames = render_scene(cfg, tr, 2 ** 32 + 77, torch.device("cpu"))
    if tr["feed"] == "host":
        frames = frames.numpy()
    e = tr["engine"]
    eng = CoSlamEngine(program_config(cfg), intrinsics(cfg),
                       np.zeros((cfg["num_cameras"], 5), np.float32),
                       device="cpu", chunk=e["chunk"], overlap=e["overlap"],
                       async_ba=e["async_ba"])
    for f in range(10):
        eng.process_frame(frames[f])
    assert spans.snapshot()["engine.frame"]["calls"] == 10
    eng.timing = {}                 # a fresh stage clock leaves the spans
    assert spans.snapshot()["engine.frame"]["calls"] == 10
    spans.reset()
    for f in range(10, 30):
        eng.process_frame(frames[f])
    snap = spans.snapshot()
    names, keys, step_key = PATHS[traffic]
    assert set(snap) == names
    assert set(eng.timing) == keys
    assert snap["engine.frame"]["calls"] == 20
    rows = spans.history()
    assert [r.name for r in rows] == ["engine.frame"] * 20
    assert [r.n for r in rows] == list(range(20))
    # the engine's count of stepped frames (a chunk's calls share it)
    frames_seen = [r.frame for r in rows]
    assert frames_seen == sorted(frames_seen) and frames_seen[-1] <= 29
    for name, (calls, host_s, self_s) in rows[5].table.items():
        assert calls <= snap[name]["calls"] and host_s <= \
            snap[name]["host_s"], name
    for key, name in [(step_key, "engine.step"), ("upload", "engine.upload"),
                      ("ba", "ba.run"), ("cad_icmap", "engine.intercam_map")]:
        assert eng.timing[key] == snap[name]["host_s"], key
    for name, row in snap.items():
        assert 0 <= row["self_s"] <= row["host_s"] + 1e-12, name
    # the step's stages nest in engine.step, the BA's in ba.run
    inside = sum(snap[n]["host_s"] for n in snap if n.startswith("step."))
    assert inside <= snap["engine.step"]["host_s"]
    assert snap["ba.solve"]["host_s"] <= snap["ba.run"]["host_s"]
    assert snap["ba.normal_terms"]["calls"] == \
        snap["ba.solve"]["calls"] * eng.cfg.p.ba_max_iter \
        * eng.cfg.p.ba_inner_iter
