"""The least work of one stereo frame's FAST + NMS, counted from the
configuration's own sizes (never from a program's padded buffers, so that
it reads the same whatever implements it).

Per pyramid level l of each of the two images, the level's pixels are
read once and one score per pixel is written once, as float32:
bytes = images × Σ_l h_l·w_l × (4 + 4), with h_l = round(h / s^l),
w_l = round(w / s^l) (``cv::round``). The least time is bytes over the
card's memory rate; FAST's arithmetic per pixel (a few dozen operations)
at 67 TFLOP/s takes less time than its bytes, so the bytes bound it.
"""

from __future__ import annotations

import math

from slam_bench.reference.peaks import HBM_BYTES_PER_S


def level_shapes(h: int, w: int, n_levels: int, scale: float):
    return [(int(math.floor(h / scale ** l + 0.5)), int(math.floor(w / scale ** l + 0.5)))
            for l in range(n_levels)]


def frame_bytes(h: int, w: int, n_levels: int, scale: float, images: int = 2) -> int:
    px = sum(hl * wl for hl, wl in level_shapes(h, w, n_levels, scale))
    return images * px * (4 + 4)


def least_seconds(h: int, w: int, n_levels: int, scale: float, images: int = 2) -> float:
    return frame_bytes(h, w, n_levels, scale, images) / HBM_BYTES_PER_S
