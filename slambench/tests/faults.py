"""Faults planted in the port's tracked step (``fused.frame_step``, which
the engine's single-frame path and its chunks both call), for the tests
that see ``correct`` come out false. Each maps the real step to a broken
one."""

import torch


def state_unchanged(real):
    """The step returns the state it was given."""
    def step(state, pyr_prev, imgs, *a, **k):
        _, pyr, fs = real(state, pyr_prev, imgs, *a, **k)
        return state, pyr, fs
    return step


def half_left_out(real):
    """The cameras of the second half keep their tracks."""
    def step(state, pyr_prev, imgs, *a, **k):
        new, pyr, fs = real(state, pyr_prev, imgs, *a, **k)
        h = max(1, state.R.shape[0] // 2)
        tr = new.tracks._replace(
            pos=torch.cat([new.tracks.pos[:h], state.tracks.pos[h:]]),
            valid=torch.cat([new.tracks.valid[:h], state.tracks.valid[h:]]))
        return new._replace(tracks=tr), pyr, fs
    return step


def _turned(real, deg: float, units: float):
    """Camera 0's pose turned by ``deg`` about y and moved ``units`` along
    x where the step produces it."""
    def step(state, pyr_prev, imgs, *a, **k):
        new, pyr, fs = real(state, pyr_prev, imgs, *a, **k)
        a_ = torch.deg2rad(torch.tensor(deg, device=new.R.device))
        Ry = torch.eye(3, device=new.R.device)
        Ry[0, 0] = Ry[2, 2] = torch.cos(a_)
        Ry[0, 2], Ry[2, 0] = torch.sin(a_), -torch.sin(a_)
        R = new.R.clone()
        t = new.t.clone()
        R[0] = Ry @ R[0]
        t[0, 0] = t[0, 0] + units
        return (new._replace(R=R, t=t), pyr,
                fs._replace(R=R.to(fs.R.device), t=t.to(fs.t.device)))
    return step


def pose_altered(real):
    """Camera 0's pose turned by 0.05 deg about y and moved 0.01 units
    along x where the step produces it."""
    return _turned(real, 0.05, 0.01)


def pyramid_altered(real):
    """The pyramid's level 0 one grey level brighter on its first row."""
    def step(state, pyr_prev, imgs, *a, **k):
        new, pyr, fs = real(state, pyr_prev, imgs, *a, **k)
        lv0 = pyr.imgs[0].clone()
        lv0[:, 0] += 1.0
        return new, pyr._replace(imgs=(lv0,) + tuple(pyr.imgs[1:])), fs
    return step


def ptype_altered(real):
    """Every tenth map slot's static/dynamic type flipped, a different
    tenth each step."""
    calls = [0]

    def step(state, pyr_prev, imgs, *a, **k):
        new, pyr, fs = real(state, pyr_prev, imgs, *a, **k)
        pt = new.mappts.ptype.clone()
        sel = slice(calls[0] % 10, None, 10)
        calls[0] += 1
        pt[sel] = 1 - torch.clamp(pt[sel], 0, 1)
        return new._replace(mappts=new.mappts._replace(ptype=pt)), pyr, fs
    return step


STEP_FAULTS = [state_unchanged, half_left_out, pose_altered, pyramid_altered,
               ptype_altered]


def plant(monkeypatch, fault):
    """Break ``frame_step`` wherever the engine calls it."""
    from coslam_torch.slam import fused, pipeline
    broken = fault(fused.frame_step)
    monkeypatch.setattr(fused, "frame_step", broken)
    monkeypatch.setattr(pipeline, "frame_step", broken)


def later_poses_altered(monkeypatch):
    """In a chunk, camera 0's pose turned by 0.5 deg and moved 0.1 units
    at every frame but the first (which stays sound)."""
    from coslam_torch.slam import fused
    real_scan, real_step = fused.frame_steps_scan, fused.frame_step
    bad = _turned(real_step, 0.5, 0.1)

    def scan(state, pyr_prev, imgs_seq, *a, **k):
        state, pyr_prev, first = real_scan(state, pyr_prev, imgs_seq[:1],
                                           *a, **k)
        fused.frame_step = bad
        try:
            state, pyr_prev, rest = real_scan(state, pyr_prev,
                                              imgs_seq[1:], *a, **k)
        finally:
            fused.frame_step = real_step
        return state, pyr_prev, torch.cat([first, rest])
    monkeypatch.setattr(fused, "frame_steps_scan", scan)


def ba_unchanged(monkeypatch):
    """The keyframe BA leaves the state as it was."""
    from coslam_torch.slam import steps
    monkeypatch.setattr(steps, "apply_ba_table_results",
                        lambda state, *a, **k: state)
