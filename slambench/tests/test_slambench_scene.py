"""The frozen scene against coslam_torch's synthetic room, and its
determinism in the seed."""

import numpy as np
import torch

from slambench import scene
from slambench.tests.tiny import CONFIG, cell


def test_frozen_scene_equals_the_ports_render():
    from coslam_torch.io import synthetic as syn
    H, W = 60, 80
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]],
                 np.float32)
    quad = dict(center0=np.array([-3.0, 0.5, 14.0], np.float32),
                velocity=np.array([0.012, 0.0, 0.0], np.float32),
                eu=np.array([1.6, 0, 0], np.float32),
                ev=np.array([0, 1.6, 0], np.float32))
    imgs = []
    for mod, q_cls in ((syn, syn.MovingQuad), (scene, scene.MovingQuad)):
        rng = np.random.default_rng(11)
        planes = mod.make_room(rng, size=10.0)
        q = q_cls(tex=mod.make_texture(rng), **quad)
        Rs, ts = syn.rig_sequence(3, 4, baseline=1.0, forward=0.04)
        Rf = Rs.transpose(1, 0, 2, 3).reshape(-1, 3, 3)
        tf = ts.transpose(1, 0, 2).reshape(-1, 3)
        fidx = np.repeat(np.arange(4), 3)
        imgs.append(mod.render_batch(planes, K, Rf, tf, H, W, quads=[q],
                                     frames=fidx, chunk=6, device="cpu"))
    assert torch.equal(imgs[0], imgs[1])
    ours = scene.rig_poses(3, 4, 1.0, {})
    assert np.allclose(ours[0], Rs.transpose(1, 0, 2, 3))
    assert np.allclose(ours[1], ts.transpose(1, 0, 2))


def test_scene_is_deterministic_in_the_seed():
    c = cell("live", frames=3)
    big = 2 ** 31 + 12345
    a = scene.render_scene(CONFIG, c["traffic"], big, "cpu")
    b = scene.render_scene(CONFIG, c["traffic"], big, "cpu")
    d = scene.render_scene(CONFIG, c["traffic"], big + 1, "cpu")
    assert a.dtype == torch.uint8 and tuple(a.shape) == (3, 2, 150, 200)
    assert torch.equal(a, b)
    assert not torch.equal(a, d)
