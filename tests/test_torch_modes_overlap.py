"""Overlap mode of the port's engine against the JAX package's: per-frame
``overlap=True`` on 40 frames of the mono room at forward 0.05 (the stats
of frame f are read while frame f+1 is enqueued; the transition frame is
not logged twice), and ``chunk=4`` with two cameras on the 20-frame rig of
tests/test_pipeline_multicam.py (whose chunks carry the grouping scan).
The scenes and bands are those of tests/torch_parity.py (engine
modes)."""

import pytest

import torch_parity as tp

MODES = {
    "overlap": (1, 40, 0.05, dict(overlap=True)),
    "two_cams_chunk4": (2, 20, 0.06, dict(chunk=4)),
}


@pytest.fixture(params=list(MODES))
def runs(request):
    return tp.mode_runs(request.param, MODES)


def test_bootstrap_and_logged_frames(runs):
    ref, port, Rs, _, _ = runs
    tp.check_bootstrap_and_logged_frames(ref, port, Rs.shape[1])


def test_keyframes(request, runs):
    ref, port, _, _, _ = runs
    lag = 1 if request.node.callspec.params["runs"] == "overlap" else 0
    tp.check_keyframes(ref, port, lag=lag)


def test_ate(runs):
    tp.check_ate(*runs)


def test_centres_agree(runs):
    ref, port, Rs, _, _ = runs
    tp.check_centres(ref, port, Rs.shape[0])


def test_buffers_drained_and_stage_clock(runs):
    ref, port, _, _, _ = runs
    tp.check_buffers_and_clock(ref, port)


def test_two_cameras_keep_one_group():
    ref, port, _, _, _ = tp.mode_runs("two_cams_chunk4", MODES)
    assert port["group_hist"] == ref["group_hist"]
