"""Chunk mode of the port's engine against the JAX package's (one camera,
40 frames of the mono room): ``chunk=4`` (with ``profile=True``) and
``chunk=4, overlap=True`` at forward 0.06, and ``chunk=5`` at forward 0.05,
whose last frames form a partial chunk that runs through the
single-frame path. The scenes and bands are those of
tests/torch_parity.py (engine modes)."""

import pytest

import torch_parity as tp

F = 40
MODES = {
    "chunk4": (1, F, 0.06, dict(chunk=4, profile=True)),
    "chunk4_overlap": (1, F, 0.06, dict(chunk=4, overlap=True)),
    "chunk5_tail": (1, F, 0.05, dict(chunk=5)),
}


@pytest.fixture(params=list(MODES))
def runs(request):
    return tp.mode_runs(request.param, MODES)


def test_bootstrap_and_logged_frames(runs):
    ref, port, Rs, _, _ = runs
    tp.check_bootstrap_and_logged_frames(ref, port, Rs.shape[1])


def test_keyframes(runs):
    ref, port, _, _, _ = runs
    tp.check_keyframes(ref, port)


def test_ate(runs):
    tp.check_ate(*runs)


def test_centres_agree(runs):
    ref, port, Rs, _, _ = runs
    tp.check_centres(ref, port, Rs.shape[0])


def test_buffers_drained_and_stage_clock(runs):
    ref, port, _, _, _ = runs
    tp.check_buffers_and_clock(ref, port)
    assert {"core_chunk", "cadence_total"} <= port["timing_keys"]
