"""Checkpoints (format v4) of the port's engine, and its feature log,
against the JAX package's, on the CPU.

- A port checkpoint resumed by the port continues as the uninterrupted
  run within 1e-4, on the 30-frame room of tests/test_io.py::
  test_checkpoint_roundtrip (120x160; that test's band: here it is
  exact).
- The rest runs on the 30-frame room of the engine parity tests
  (tests/torch_parity.py: 150x200, forward 0.06), whose bands were set on
  it.
- A checkpoint crosses the packages in both directions with the same npz
  keys, dtypes and shapes; the resumed engine continues within the engine
  parity bands of tests/torch_parity.py (ATE under 0.20, camera centres
  within 5% of the path, RMS after Sim(3) alignment) of the engine that
  wrote the checkpoint and ran on.
- v3 and v2 files load.
- ``feat_log`` of the two engines (the port taking over the JAX engine's
  bootstrap, as the mode tests do): the same (frame, camera) stamps; per
  entry at least 90% of the map ids in both logs, and of those at least
  90% at the same pixel within 0.05 px (measured: 93.6% and 94.5%; slots
  minted in another order or a track dropped a frame apart move the
  rest).
"""

import json

import numpy as np
import pytest

import torch_parity as tp

F, SAVE = 30, 20
KC = np.zeros((1, 5), np.float32)
KSMALL = np.array([[[150.0, 0, 80], [0, 150.0, 60], [0, 0, 1]]], np.float32)


def _port_engine(hw=(tp.H, tp.W), K=tp.KMAT, **kw):
    from coslam_torch.config import small_test_config
    from coslam_torch.slam.pipeline import CoSlamEngine
    return CoSlamEngine(small_test_config(1, *hw), K, KC, device="cpu",
                        **kw)


def _jax_engine(**kw):
    from coslam_tpu.config import small_test_config
    from coslam_tpu.slam.pipeline import CoSlamEngine
    return CoSlamEngine(small_test_config(1, tp.H, tp.W), tp.KMAT, KC, **kw)


def _boot_snapshot(eng, f):
    return dict(frame=f, state=tp.to_numpy(eng.state),
                pyr=tp.to_numpy(eng.pyr_prev), kf_frames=list(eng.kf_frames),
                kf_inliers=np.array(eng._kf_inliers),
                traj=[[(np.array(R), np.array(t)) for R, t in tr]
                      for tr in eng.traj],
                rel=[[(np.array(R), np.array(t)) for R, t in tr]
                     for tr in eng.rel])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both engines over the room with log_features, each saving a
    checkpoint after frame SAVE - 1 and running on; the port's takes over
    the JAX engine's bootstrap."""
    from coslam_tpu.io.checkpoint import save_checkpoint as jsave
    from coslam_torch.io.checkpoint import save_checkpoint
    root = tmp_path_factory.mktemp("ckpt")
    frames, Rs, ts = tp.render_mono_frames(F)
    jeng = _jax_engine(log_features=True)
    boot = None
    for f in range(F):
        if f == SAVE:
            jsave(str(root / "jax.npz"), jeng)
        jeng.process_frame(frames[f][None])
        if boot is None and jeng.bootstrapped:
            boot = _boot_snapshot(jeng, f)
    teng = _port_engine(log_features=True)
    for f in range(F):
        if f == SAVE:
            save_checkpoint(str(root / "port.npz"), teng)
        teng.process_frame(frames[f][None])
        if f == boot["frame"]:
            assert teng.bootstrapped
            tp._hand_over(teng, boot)
    return dict(frames=frames, Rs=Rs, ts=ts, jax=jeng, port=teng,
                jax_ck=str(root / "jax.npz"), port_ck=str(root / "port.npz"))


def test_port_resume_equals_uninterrupted(tmp_path):
    from coslam_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from coslam_torch.io.synthetic import (make_room, orbit_trajectory,
                                           render_sequence)
    planes = make_room(np.random.default_rng(0), size=10.0)
    Rs, ts = orbit_trajectory(F, forward=0.06)
    frames = tp.n(render_sequence(planes, KSMALL[0], Rs, ts, 120, 160,
                                  device="cpu"))
    small = dict(hw=(120, 160), K=KSMALL)
    eng = _port_engine(**small)
    for f in range(SAVE):
        eng.process_frame(frames[f][None])
    ck = str(tmp_path / "ck.npz")
    save_checkpoint(ck, eng)
    for f in range(SAVE, F):
        eng.process_frame(frames[f][None])
    eng2 = _port_engine(**small)
    load_checkpoint(ck, eng2)
    assert eng2.frame == SAVE and eng2.bootstrapped == eng.bootstrapped
    assert eng2.pyr_prev is not None and len(eng2.pyr_prev.dxs) == 1
    for f in range(SAVE, F):
        eng2.process_frame(frames[f][None])
    R1, t1 = eng.trajectory(0, correct=False)
    R2, t2 = eng2.trajectory(0, correct=False)
    np.testing.assert_allclose(t2, t1, atol=1e-4)
    np.testing.assert_allclose(R2, R1, atol=1e-4)
    assert eng2.kf_frames == eng.kf_frames


def _layout(path):
    d = np.load(path)
    return {k: (d[k].dtype, d[k].shape) for k in d.files if k != "meta"}, \
        json.loads(bytes(d["meta"]).decode())


def test_checkpoint_layouts_match(runs):
    a, ma = _layout(runs["jax_ck"])
    b, mb = _layout(runs["port_ck"])
    assert a == b
    assert sorted(ma) == sorted(mb) and ma["version"] == mb["version"] == 4
    assert ma["frame"] == mb["frame"] == SAVE
    assert any(k.startswith("pyr.imgs.") for k in a)


def _continue(eng, frames):
    for f in range(SAVE, F):
        eng.process_frame(frames[f][None])
    return eng.trajectory(0, correct=True)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_packages(runs, direction):
    from coslam_tpu.io.checkpoint import load_checkpoint as jload
    from coslam_torch.io.ate import ate_rmse
    from coslam_torch.io.checkpoint import load_checkpoint
    if direction == "jax_to_port":
        eng, writer = load_checkpoint(runs["jax_ck"], _port_engine()), \
            runs["jax"]
        assert eng.device.type == "cpu"
        assert eng.pyr_prev.imgs[0].device.type == "cpu"
    else:
        eng, writer = jload(runs["port_ck"], _jax_engine()), runs["port"]
    assert eng.frame == SAVE and eng.bootstrapped
    assert eng.kf_frames == [f for f in writer.kf_frames if f < SAVE]
    traj = _continue(eng, runs["frames"])
    ref = writer.trajectory(0, correct=True)
    assert ate_rmse(*traj, runs["Rs"], runs["ts"]) < 0.20
    gap, path = tp.aligned_gap(traj, ref)
    assert gap < 0.05 * path, (gap, path)


@pytest.mark.parametrize("version", [3, 2])
def test_older_versions_load(runs, tmp_path, version):
    """v3 stored pyramid derivatives for every level (the extras are
    dropped); v2 lacks the long-horizon rings (they start empty)."""
    from coslam_torch.io.checkpoint import load_checkpoint
    d = dict(np.load(runs["port_ck"]))
    meta = json.loads(bytes(d.pop("meta")).decode())
    meta["version"] = version
    if version == 3:
        for li in (1, 2):
            d[f"pyr.dxs.{li}"] = d[f"pyr.imgs.{li}"]
            d[f"pyr.dys.{li}"] = d[f"pyr.imgs.{li}"]
    else:
        for k in ("state.tracks.hist_long", "state.tracks.hist_long_valid",
                  "state.pose_hist_long_R", "state.pose_hist_long_t"):
            del d[k]
    d["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    path = str(tmp_path / f"v{version}.npz")
    np.savez_compressed(path, **d)
    eng = load_checkpoint(path, _port_engine())
    assert len(eng.pyr_prev.dxs) == len(eng.pyr_prev.dys) == 1
    if version == 2:
        assert not bool(eng.state.tracks.hist_long_valid.any())
    traj = _continue(eng, runs["frames"])
    assert np.isfinite(traj[0]).all() and np.isfinite(traj[1]).all()
    meta["version"] = 1
    d["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(path, **d)
    with pytest.raises(ValueError):
        load_checkpoint(path, _port_engine())


def test_feat_log_matches_jax(runs):
    a, b = runs["jax"].feat_log, runs["port"].feat_log
    assert [(e[0], e[1]) for e in a] == [(e[0], e[1]) for e in b]
    assert [e[0] for e in b] == list(range(10, F))
    for (fr, _, ia, xa), (_, _, ib, xb) in zip(a, b):
        assert ib.dtype == np.int32 and xb.dtype == np.float32
        ja = {int(i): k for k, i in enumerate(ia)}
        jb = {int(i): k for k, i in enumerate(ib)}
        common = sorted(set(ja) & set(jb))
        assert len(common) >= 0.9 * max(len(ja), len(jb)), fr
        d = np.array([np.abs(xa[ja[i]] - xb[jb[i]]).max() for i in common])
        assert (d < 0.05).mean() >= 0.9, fr
