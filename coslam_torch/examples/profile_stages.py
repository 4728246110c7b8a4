"""Per-stage timing of the fused frame step (the port of
``examples/profile_stages.py``).

Times each stage of ``slam/fused.py::frame_step`` as its own chain of
``--iters`` calls at the bench shape (3 cameras x 480x640 x 1024
features, 8192 map points, 64 keyframes, BA window 5). Every timed window
opens after a ``torch.cuda.synchronize()`` and closes on one before the
clock stops, so a stage's time is the card's execution of the chain and
the host's launches that feed it (eager PyTorch launches op by op). On the
card each stage also reports the launches of the hand-written kernels it
made per call: ``build_pyramid`` launches ``csrc/build_pyramid.cu``,
``advance_tracks`` ``csrc/klt_track.cu`` and ``new_map_points``
``csrc/ncc_blocks.cu``.

    python -m coslam_torch.examples.profile_stages [--iters 30] [--cpu]

Runs on the CUDA card unless given ``--cpu``; raises without a card
otherwise. The first line names the card and its power limit (nvidia-smi)
or ``cpu``.
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from coslam_torch.ops import kernel_wrappers
from coslam_torch.util import resolve_device

STAGES = ("build_pyramid", "advance_tracks (KLT)", "pose_update (IRLS+gate)",
          "dyn-detect + classify", "new_map_points", "frame_step (fused)")


def bench_config(C: int = 3, H: int = 480, W: int = 640, n_levels: int = 4,
                 max_features: int = 1024):
    """The bench's production configuration (``examples/profile_*.py``):
    8192 map points, 64 keyframes, BA window 5."""
    from coslam_torch.config import CapacityConfig, KLTConfig, SlamConfig
    return SlamConfig(
        num_cameras=C, image_height=H, image_width=W,
        klt=KLTConfig(n_levels=n_levels),
        cap=CapacityConfig(max_features=max_features, max_map_points=8192,
                           max_keyframes=64, ba_window=5))


class StageInputs(NamedTuple):
    cfg: object
    state: object          # after one fused step: a populated track table
    pyr0: object           # the pyramid that step returned
    imgs_prev: torch.Tensor
    imgs_cur: torch.Tensor
    K: torch.Tensor
    kc: torch.Tensor


def stage_inputs(C: int = 3, H: int = 480, W: int = 640, n_levels: int = 4,
                 max_features: int = 1024, device=None) -> StageInputs:
    """The reference's inputs: twice-blurred uniform noise from seed 0,
    rolled by 2 px, and one fused ``frame_step`` from ``init_state`` for a
    populated state."""
    from coslam_torch.ops import build_pyramid
    from coslam_torch.ops.image import gaussian_blur
    from coslam_torch.slam.fused import frame_step
    from coslam_torch.slam.state import init_state
    dev = resolve_device(device)
    cfg = bench_config(C, H, W, n_levels, max_features)
    state = init_state(cfg, dev)
    rng = np.random.default_rng(0)
    base = torch.as_tensor(rng.uniform(0, 255, (C, H, W)).astype(np.float32),
                           device=dev)
    imgs_prev = gaussian_blur(gaussian_blur(base))
    imgs_cur = torch.roll(imgs_prev, 2, dims=-1)
    K = torch.as_tensor(np.broadcast_to(np.array(
        [[500.0, 0, W / 2], [0, 500.0, H / 2], [0, 0, 1]], np.float32),
        (C, 3, 3)).copy(), device=dev)
    kc = torch.zeros((C, 5), dtype=torch.float32, device=dev)
    pyr0 = build_pyramid(imgs_prev, cfg.klt.n_levels)
    state, pyr0, _ = frame_step(state, pyr0, imgs_cur, K, kc, cfg)
    return StageInputs(cfg, state, pyr0, imgs_prev, imgs_cur, K, kc)


def sync(device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_chain(fn, n: int, device):
    """``carry = fn(carry)`` n times from ``fn(None)`` (the first call
    builds the kernels and the carry). Returns (ms a call, the kernels'
    launches a call) over the n timed calls; the wrappers' counts are read,
    not reset."""
    carry = fn(None)
    sync(device)
    wrappers = kernel_wrappers()
    before = {k: w.launches for k, w in wrappers.items()}
    t0 = time.perf_counter()
    for _ in range(n):
        carry = fn(carry)
    sync(device)
    ms = (time.perf_counter() - t0) / n * 1e3
    return ms, {k: (w.launches - before[k]) / n
                for k, w in wrappers.items()}


def run(iters: int = 30, C: int = 3, H: int = 480, W: int = 640,
        n_levels: int = 4, max_features: int = 1024, device=None) -> dict:
    """Time every stage; print the reference's lines. Returns {"ms":
    {stage: ms a call}, "launches": {stage: {kernel: launches a call}},
    "sum_ms", "fused_fps"}."""
    from coslam_torch.ops import build_pyramid
    from coslam_torch.slam import steps
    from coslam_torch.slam.classify import (classify_map_points,
                                            detect_dynamic_features)
    from coslam_torch.slam.fused import frame_step
    dev = resolve_device(device)
    inp = stage_inputs(C, H, W, n_levels, max_features, dev)
    cfg, state, pyr0, K, kc = inp.cfg, inp.state, inp.pyr0, inp.K, inp.kc
    imgs_cur, L, img_hw = inp.imgs_cur, cfg.klt.n_levels, (H, W)

    def fused(c):
        st, pyr = (state, pyr0) if c is None else c
        st, pyr, _ = frame_step(st, pyr, imgs_cur, K, kc, cfg)
        return st, pyr

    chains = {
        STAGES[0]: lambda c: build_pyramid(
            imgs_cur if c is None else c.imgs[0][..., :H, :W] * 1.0, L),
        STAGES[1]: lambda c: steps.advance_tracks(
            pyr0, pyr0, state.tracks if c is None else c, K, kc,
            state.frame, cfg),
        STAGES[2]: lambda c: (lambda st: st._replace(R=steps.pose_update(
            st, K, kc, img_hw, cfg).R))(state if c is None else c),
        STAGES[3]: lambda c: (lambda st: st._replace(
            mappts=classify_map_points(detect_dynamic_features(st, K, cfg),
                                       K, cfg).mappts))(
            state if c is None else c),
        STAGES[4]: lambda c: (lambda st: st._replace(
            mappts=steps.new_map_points(st, pyr0, K, kc, cfg)[0]))(
            state if c is None else c),
        STAGES[5]: fused,
    }
    out = {"ms": {}, "launches": {}}
    for name, fn in chains.items():
        if name == STAGES[5]:
            out["sum_ms"] = sum(out["ms"].values())
            print(f"{'sum of stages':26s} {out['sum_ms']:8.3f} ms")
        out["ms"][name], out["launches"][name] = timed_chain(fn, iters, dev)
        print(f"{name:26s} {out['ms'][name]:8.3f} ms", flush=True)
    out["fused_fps"] = 1000.0 / out["ms"][STAGES[5]]
    print(f"{'fused fps':26s} {out['fused_fps']:8.1f}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    from coslam_torch.examples.accuracy_bench import device_label
    device = "cpu" if args.cpu else None
    print(device_label(device), flush=True)        # raises without a card
    return run(iters=args.iters, device=device)


if __name__ == "__main__":
    main()
