"""Asynchronous BA and the non-fused path of the port's engine against the
JAX package's, on 40 frames of the mono room at forward 0.06:
``async_ba=True`` (the solve is dispatched and applied a frame or more
later with the slot-generation guard), ``use_fused=False`` with
``profile=True`` (the stages as separate calls, lifecycle after the
cadence), and the default fused path with ``profile=True`` for the stage
clock. The scenes and bands are those of tests/torch_parity.py (engine
modes); async BA also needs two or more dispatches that stayed in flight
past their frame in both engines, and a finite map of more than 60
points."""

import numpy as np
import pytest

import torch_parity as tp

MODES = {
    "async_ba": (1, 40, 0.06, dict(async_ba=True)),
    "non_fused": (1, 40, 0.06, dict(use_fused=False, profile=True)),
    "fused_profile": (1, 40, 0.06, dict(profile=True)),
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


def test_async_ba_dispatches_and_map():
    """Both engines dispatch two or more BAs asynchronously (the JAX
    engine's stay in flight past their frame; the port's CPU solve has run
    by the poll right after its dispatch, which applies it), and keep a
    finite map."""
    ref, port, _, _, _ = tp.mode_runs("async_ba", MODES)
    counts = port["engine"].ba_async
    assert ref["dispatches"] >= 2
    assert counts["dispatched"] == port["engine"].ba_runs >= 2
    assert counts["dispatched"] == counts["ready"]
    assert port["engine"]._pending_ba is None
    assert port["n_map"] > 60 and ref["n_map"] > 60


class _Solving:
    """A CUDA event stand-in for a solve still running."""

    def query(self):
        return False


def test_pending_ba_waits_for_its_solve_or_max_defer():
    """A dispatched solve that has not finished stays in flight through
    the polls of the next frames and is applied at max_defer frames; a
    keyframe's flush applies it at once, with the generation guard; a
    cancel drops it and leaves the state as it was."""
    from coslam_torch.slam.state import state_to_numpy
    port = tp.mode_runs("async_ba", MODES)[1]["engine"]
    port._run_ba()
    assert port._pending_ba is not None
    port._pending_ba["done"] = _Solving()
    f0 = port._pending_ba["frame"]
    applied = dict(port.ba_async)
    for k in range(1, 9):
        port.frame = f0 + k
        port._poll_ba()
        assert (port._pending_ba is None) == (k >= 8), k
    assert port.ba_async["deferred"] == applied["deferred"] + 1
    port._run_ba()
    port._pending_ba["done"] = _Solving()
    port._apply_pending_ba()
    assert port._pending_ba is None
    assert port.ba_async["flushed"] == applied["flushed"] + 1
    port._run_ba()
    before = state_to_numpy(port.state)
    port._cancel_pending_ba()
    assert port._pending_ba is None
    assert port.ba_async["cancelled"] == applied["cancelled"] + 1
    after = state_to_numpy(port.state)
    for a, b in zip(tp.leaves(before), tp.leaves(after)):
        np.testing.assert_array_equal(a, b)
