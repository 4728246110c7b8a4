"""Cumulative ablation timing of the fused frame step against a
speed-of-light byte count (the port of ``examples/profile_ablate.py``).

Variant k runs stages 0..k of ``frame_step`` (pyramid, KLT tracks, pose
update, dynamic detection, classification, new map points) from the same
populated state; the difference between consecutive variants is the cost
of the added stage. In eager PyTorch a variant's wall time per call is
mostly the host launching its operators, so on the card each variant is
timed twice: the wall per call of ``--iters`` chained calls (a window
between two ``torch.cuda.synchronize()``), and the device-busy time per
call, the summed durations of the card's activities in one
``torch.profiler`` run of as many calls, made after every variant's wall
window. The deltas
and their share of the speed-of-light time (the stage's main-array bytes,
``sol_bytes``, over the H100's 3.35 TB/s HBM3) are taken on device-busy
time; the wall delta beside them shows the host's cost. On the CPU only
the wall is reported.

    python -m coslam_torch.examples.profile_ablate [--iters 30] [--cpu]

Runs on the CUDA card unless given ``--cpu``; raises without a card
otherwise. The first line names the card and its power limit (nvidia-smi)
or ``cpu``.
"""

from __future__ import annotations

import argparse
import time

import torch

from coslam_torch.examples.profile_stages import stage_inputs, sync
from coslam_torch.util import resolve_device

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA data sheet
VARIANTS = ("pyramid", "+advance_tracks", "+pose_update", "+dyn_detect",
            "+classify", "+new_map_points")


def sol_bytes(cfg, C: int, H: int, W: int) -> dict:
    """Main-array traffic (reads + writes, f32) of each added stage: a
    lower bound on its time at peak bandwidth. The reference's formulas,
    unchanged."""
    N = cfg.cap.max_features
    P = cfg.cap.max_map_points
    T = 21                                  # history ring (history_len)
    L = cfg.klt.n_levels
    win = (2 * cfg.klt.window_radius + 1) ** 2
    lvl_px = sum((H >> lv) * (W >> lv) for lv in range(L))
    return {
        # read gray, write img+dx+dy per level (f32)
        "pyramid": C * 4 * (H * W + 3 * lvl_px + 2 * lvl_px),
        # per level+iter: read 2 windows (cur via resample ~2x) + write
        "+advance_tracks": C * N * 4 * L * cfg.klt.n_iterations * win * 3,
        # gating/refine: [C,N] component arrays, ~40 passes + cov gathers
        "+pose_update": C * N * 4 * 40 + C * N * 9 * 4 * 2,
        # F-matrix epipolar over [C,T,N]
        "+dyn_detect": C * T * N * 4 * 8,
        # classify: obs table + [T,P] windowed test + C^2 drop-one-view
        "+classify": P * 4 * (10 + 2 * T) + C * C * P * 4 * 6,
        # history-pair triangulation [C,T,N] ~ 30 component arrays
        "+new_map_points": C * T * N * 4 * 30,
    }


def variant(state, pyr_prev, upto: int, inp):
    """Stages 0..``upto`` of the fused step from ``state`` (line for line
    the reference's): returns (state', pyr_cur). The frames depend on the
    state (``imgs_cur + state.t[0, 0]``, a device tensor: no host wait),
    so chained calls cannot be reordered."""
    from coslam_torch.ops import build_pyramid
    from coslam_torch.slam import steps
    from coslam_torch.slam.classify import (classify_map_points,
                                            detect_dynamic_features)
    cfg, K, kc = inp.cfg, inp.K, inp.kc
    img_hw = tuple(inp.imgs_cur.shape[-2:])
    pyr_cur = build_pyramid(inp.imgs_cur + state.t[0, 0], cfg.klt.n_levels)
    if upto == 0:
        return state, pyr_cur
    tracks = steps.advance_tracks(pyr_prev, pyr_cur, state.tracks, K,
                                  kc, state.frame + 1, cfg)
    state = state._replace(tracks=tracks, frame=state.frame + 1)
    if upto == 1:
        return state, pyr_cur
    out = steps.pose_update(state, K, kc, img_hw, cfg)
    state = state._replace(R=out.R, t=out.t, tracks=out.tracks,
                           mappts=out.mappts)
    state = steps.push_pose_history(state)
    if upto == 2:
        return state, pyr_cur
    state = detect_dynamic_features(state, K, cfg)
    if upto == 3:
        return state, pyr_cur
    cls = classify_map_points(state, K, cfg)
    state = state._replace(mappts=cls.mappts)
    if upto == 4:
        return state, pyr_cur
    mappts, tracks2, n_new = steps.new_map_points(state, pyr_cur, K,
                                                  kc, cfg)
    state = state._replace(mappts=mappts, tracks=tracks2)
    return state, pyr_cur


def device_busy_us(prof) -> tuple[float, int]:
    """(summed duration in µs, count) of the device activities in a
    finished ``torch.profiler`` run, read from its raw trace: no
    FunctionEvent tree and no ``key_averages`` table, which take seconds
    to minutes over the 10^4-10^5 events of a few frames."""
    cuda = torch.autograd.DeviceType.CUDA
    busy_ns, n = 0, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda and not e.is_hidden_event():
            busy_ns += e.duration_ns()
            n += 1
    return busy_ns / 1e3, n


def _ms(v) -> str:
    return "    n/a" if v is None else f"{v:7.3f}"


def run(iters: int = 30, C: int = 3, H: int = 480, W: int = 640,
        n_levels: int = 4, max_features: int = 1024, device=None) -> dict:
    """Time the six variants; print the reference's lines. Returns {"rows":
    [{"name", "wall_ms", "wall_delta_ms", "busy_ms", "delta_ms", "sol_ms",
    "sol_share"}, ...]}; ``busy_ms`` is None on the CPU, where the deltas
    and shares are taken on the wall, and on the card where a trace held
    no device activity (then the deltas beside it are None too)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    inp = stage_inputs(C, H, W, n_levels, max_features, dev)
    sol = sol_bytes(inp.cfg, C, H, W)

    def chain(upto):
        st, pyr = inp.state, inp.pyr0
        for _ in range(iters):
            st, pyr = variant(st, pyr, upto, inp)
        sync(dev)

    walls = []
    for upto in range(len(VARIANTS)):
        variant(inp.state, inp.pyr0, upto, inp)         # kernel builds
        sync(dev)
        t0 = time.perf_counter()
        chain(upto)
        walls.append((time.perf_counter() - t0) / iters * 1e3)
    # the profiler runs come after every wall window: the first launches
    # after a profiler run are slower, and would land in the next window.
    # A trace that holds no device activity reads "not measured" (None):
    # on the H100, late in chip_smoke's process, the pyramid variant's
    # 0.1 ms chain came back empty in some runs
    busys = [None] * len(VARIANTS)
    if on_card:
        from torch.profiler import ProfilerActivity, profile
        for upto in range(len(VARIANTS)):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                chain(upto)
            busy_us, n = device_busy_us(prof)
            busys[upto] = busy_us / iters / 1e3 if n else None
    rows, prev_wall, prev = [], 0.0, 0.0
    for name, wall, busy in zip(VARIANTS, walls, busys):
        dt = busy if on_card else wall
        sol_ms = sol[name] / HBM_BYTES_PER_S * 1e3
        delta = None if dt is None or prev is None else dt - prev
        share = sol_ms / delta if delta is not None and delta > 0 else None
        eff = f"{100 * share:5.1f}%" if share is not None else "  n/a"
        row = dict(name=name, wall_ms=wall, wall_delta_ms=wall - prev_wall,
                   busy_ms=busy, delta_ms=delta, sol_ms=sol_ms,
                   sol_share=share)
        rows.append(row)
        card_txt = (f" (wall delta {row['wall_delta_ms']:7.3f} ms)   busy "
                    f"{_ms(busy)} ms" if on_card else "")
        print(f"{name:22s} cum {wall:7.3f} ms{card_txt}   delta "
              f"{_ms(delta)} ms   SoL {sol_ms:6.3f} ms  ({eff} of "
              f"bandwidth ceiling)", flush=True)
        prev_wall, prev = wall, dt
    return {"rows": rows}


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
