"""I/O parity: the port's synthetic room and ATE against the JAX package's.
With the same numpy generator the rooms, textures and trajectories must
be equal (set-up data made on the host), and the renders equal to
float32 rounding of the ray-plane arithmetic (≤ 0.02 grey levels of 255:
a texture lookup moves by at most a few 1e-5 texels)."""

import numpy as np
import pytest

import torch_parity as tp


def test_room_and_trajectory_equal():
    from coslam_tpu.io import synthetic as js
    from coslam_torch.io import synthetic as ts
    a = js.make_room(np.random.default_rng(0), size=10.0)
    b = ts.make_room(np.random.default_rng(0), size=10.0)
    assert len(a) == len(b) == 5
    for pa, pb in zip(a, b):
        for f in pa._fields:
            np.testing.assert_allclose(np.asarray(getattr(pb, f)),
                                       np.asarray(getattr(pa, f)), rtol=0,
                                       atol=2e-4, err_msg=f)
    for kw in (dict(), dict(forward=0.06), dict(radius=0.5, yaw_rate=0.01)):
        for x, y in zip(js.orbit_trajectory(40, **kw),
                        ts.orbit_trajectory(40, **kw)):
            np.testing.assert_allclose(y, x, atol=1e-6)


@pytest.mark.parametrize("h,w", [(150, 200), (96, 160)])
def test_render_sequence_matches(h, w):
    from coslam_tpu.io import synthetic as js
    from coslam_torch.io import synthetic as ts
    planes = js.make_room(np.random.default_rng(0), size=10.0)
    Rs, tt = js.orbit_trajectory(6, forward=0.3, yaw_rate=0.05)
    K = np.array([[0.9 * w, 0, w / 2], [0, 0.9 * w, h / 2], [0, 0, 1]],
                 np.float32)
    want = np.asarray(js.render_sequence(planes, K, Rs, tt, h, w))
    got = tp.n(ts.render_sequence(planes, K, Rs, tt, h, w, device="cpu"))
    assert got.shape == want.shape == (6, h, w)
    assert np.abs(got - want).max() <= 0.02
    one = tp.n(ts.render(planes, K, Rs[3], tt[3], h, w, device="cpu"))
    np.testing.assert_array_equal(one, got[3])


def test_ate_and_umeyama_match(rng):
    from coslam_tpu.io import ate as ja
    from coslam_torch.io import ate as ta
    from coslam_tpu.io.synthetic import orbit_trajectory
    Rs, ts = orbit_trajectory(50, forward=0.06)
    src = rng.standard_normal((50, 3))
    dst = 2.5 * src @ np.linalg.qr(rng.standard_normal((3, 3)))[0].T + 1.0
    for with_scale in (True, False):
        for x, y in zip(ja.umeyama(src, dst, with_scale),
                        ta.umeyama(src, dst, with_scale)):
            np.testing.assert_allclose(y, x, atol=1e-9)
    noisy = ts + 0.05 * rng.standard_normal(ts.shape)
    assert ta.ate_rmse(Rs, noisy, Rs, ts) == \
        pytest.approx(ja.ate_rmse(Rs, noisy, Rs, ts), abs=1e-12)
    np.testing.assert_allclose(ta.camera_centers(Rs, ts),
                               ja.camera_centers(Rs, ts))
