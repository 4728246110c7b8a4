"""The engine's feature log (``log_features=True``) in every engine mode
of the port, on the CPU. Each logged entry must equal the mapped
features of the state at the end of the call that logged it, as the JAX
engine logs them (``coslam_tpu/slam/pipeline.py::_log_features``, called
after the cadence), in the chunk and overlap modes too. The room of the
engine parity tests (tests/torch_parity.py, 150x200, forward 0.06),
rendered by the port."""

import numpy as np
import pytest

import torch_parity as tp

F = 30


def _frames():
    from coslam_torch.io.synthetic import (make_room, orbit_trajectory,
                                           render_sequence)
    planes = make_room(np.random.default_rng(0), size=10.0)
    Rs, ts = orbit_trajectory(F, forward=0.06)
    return tp.n(render_sequence(planes, tp.KMAT[0], Rs, ts, tp.H, tp.W,
                                device="cpu"))


def _port_engine(**kw):
    from coslam_torch.config import small_test_config
    from coslam_torch.slam.pipeline import CoSlamEngine
    return CoSlamEngine(small_test_config(1, tp.H, tp.W), *tp.kmats(1),
                        device="cpu", **kw)


@pytest.mark.parametrize("kw", [dict(), dict(overlap=True), dict(chunk=4),
                                dict(chunk=4, overlap=True),
                                dict(use_fused=False)])
def test_feat_log_is_the_state_after_the_call(kw):
    """Each logged entry equals the mapped features of the state at the
    end of the call that logged it (``trajectory`` runs the frames a
    partial chunk left buffered: the last of its entries is the final
    state); logging changes no pose."""
    frames = _frames()
    eng = _port_engine(log_features=True, **kw)

    def table():
        tr = eng.state.tracks
        ok = tp.n(tr.valid)[0] & (tp.n(tr.mpt)[0] >= 0)
        return tp.n(tr.mpt)[0][ok], tp.n(tr.pos)[0][ok]

    made = []
    for f in range(F):
        n0 = len(eng.feat_log)
        eng.process_frame(frames[f][None])
        made.append((n0, len(eng.feat_log), *table()))
    eng.trajectory(0)
    made.append((made[-1][1], len(eng.feat_log), *table()))
    assert made[-1][1] > made[-2][1] or kw.get("chunk", 1) == 1
    stamps = []
    for k, (n0, n1, ids, xy) in enumerate(made):
        entries = eng.feat_log[n0:n1]
        if k == len(made) - 1:
            entries = entries[-1:]
        for fr, c, got_ids, got_xy in entries:
            stamps.append(fr)
            np.testing.assert_array_equal(got_ids, ids)
            np.testing.assert_array_equal(got_xy, xy)
    stamps = [e[0] for e in eng.feat_log]
    assert stamps == sorted(stamps) and len(set(stamps)) == len(stamps)
    assert stamps[0] == 10 and stamps[-1] == F - 1
    if kw == dict(chunk=4, overlap=True):
        ref = _port_engine(**kw)
        for f in range(F):
            ref.process_frame(frames[f][None])
        np.testing.assert_array_equal(ref.trajectory(0)[1],
                                      eng.trajectory(0)[1])
