"""Bytes and operations of one ``build_pyramid`` call on a [C, H, W] batch:
the input and level 0's two derivatives, and every level written once;
18 flop a pixel of every level (the 5-tap blur both ways), 20 a level-0
pixel (the derivatives) and 4 a pixel of the coarser levels (the 2x2
average). The arithmetic of chip_smoke.py's kernel phase."""


def work(cfg: dict, samples) -> tuple[float, float]:
    C, H, W = cfg["num_cameras"], cfg["image_height"], cfg["image_width"]
    px = [C * (H >> lv) * (W >> lv) for lv in range(cfg["klt"]["n_levels"])]
    nbytes = px[0] * 4 * 3 + sum(px) * 4
    flop = sum(p * 18 for p in px) + px[0] * 20 + sum(px[1:]) * 4
    return float(nbytes), float(flop)
