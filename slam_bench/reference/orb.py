"""Plain reference of the ORB front end's stated algorithm, in float64:
the image pyramid, the intensity-centroid orientation and the steered
rBRIEF descriptor of a keypoint.

What it follows (the algorithm the configuration states, not any one
implementation of it):

- level l is resized from level l-1 to (round(h / s^l), round(w / s^l))
  by the separable antialiased triangle filter (``linear`` resizing with
  antialiasing: the kernel widened by 1/scale when shrinking, each row of
  weights normalised to sum 1); pixels outside a level read 0;
- orientation: atan2(m01, m10) of the unblurred level image over the disc
  of radius 15 around the keypoint;
- keypoints: FAST-9 on the 16-pixel Bresenham circle of radius 3 (a
  corner has 9 contiguous circle pixels brighter than centre + t, or 9
  darker than centre - t), at the configuration's initial and minimum
  thresholds; a corner's score is the larger polarity's sum of margins
  beyond t over the circle, where the circle fits in the level; 3x3
  non-maximum suppression (a keypoint is >= each neighbour); keypoints lie
  ``BORDER`` pixels inside the level's edges; the keypoint's level coordinates are its level-0 coordinates over
  scale^level, to half a pixel;
- descriptor: the level image blurred by the 7x7 Gaussian of sigma 2; the
  256 point pairs of the canonical rBRIEF pattern (``orb_pattern.npy``,
  bit_pattern_31 of Rublee et al. 2011) rotated by the orientation
  quantised to 96 steering bins (3.75 degrees) and rounded to pixels
  (clipped to ±19); bit i = value(p1) < value(p2), the values rounded to
  bfloat16 before the comparison; bits packed little-endian into eight
  32-bit words.

``values_dtype`` selects the rounding before the comparison; the control
passes ``torch.float8_e4m3fn``, the precision below bfloat16.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

PATTERN = np.load(os.path.join(os.path.dirname(__file__), "orb_pattern.npy")).astype(np.float64)
N_BINS = 96
HALF_PATCH = 15
BLUR_R = 3
SAMPLE_R = 19
BORDER = 19  # EDGE_THRESHOLD of ORB-SLAM's extractor
CIRCLE = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
          (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] float64 antialiased triangle-filter weights."""
    scale = n_out / n_in
    centre = (np.arange(n_out) + 0.5) / scale - 0.5
    k = min(scale, 1.0)
    w = np.maximum(0.0, 1.0 - np.abs(centre[:, None] - np.arange(n_in)[None, :]) * k)
    return w / w.sum(axis=1, keepdims=True)


def level_shapes(h: int, w: int, n_levels: int, scale: float):
    return [(int(math.floor(h / scale ** l + 0.5)), int(math.floor(w / scale ** l + 0.5)))
            for l in range(n_levels)]


def pyramid(img: torch.Tensor, n_levels: int, scale: float):
    """[H,W] image -> list of float64 level images."""
    img = img.to(torch.float64)
    shapes = level_shapes(img.shape[0], img.shape[1], n_levels, scale)
    levels = [img]
    for hl, wl in shapes[1:]:
        prev = levels[-1]
        A = torch.from_numpy(resize_weights(prev.shape[0], hl)).to(img.device)
        B = torch.from_numpy(resize_weights(prev.shape[1], wl)).to(img.device)
        levels.append(A @ prev @ B.T)
    return levels


def _gauss7() -> torch.Tensor:
    x = torch.arange(7, dtype=torch.float64) - 3.0
    g = torch.exp(-(x * x) / 8.0)
    return g / g.sum()


def _patches(level: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, r: int) -> torch.Tensor:
    """[M, 2r+1, 2r+1] windows of ``level`` centred at (rows, cols), 0
    outside the level."""
    pad = torch.nn.functional.pad(level, (r, r, r, r))
    off = torch.arange(-r, r + 1, device=level.device)
    rr = (rows[:, None] + off[None, :] + r)[:, :, None]
    cc = (cols[:, None] + off[None, :] + r)[:, None, :]
    return pad[rr, cc]


def describe(levels, level_idx: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
             values_dtype=torch.bfloat16):
    """Orientation [M] (radians) and packed descriptors [M, 8] (int64
    holding the 32-bit words) of keypoints at integer level coordinates
    (rows, cols) of levels ``level_idx``."""
    dev = levels[0].device
    M = rows.shape[0]
    R = SAMPLE_R + BLUR_R
    win = torch.zeros((M, 2 * R + 1, 2 * R + 1), dtype=torch.float64, device=dev)
    for l, lev in enumerate(levels):
        sel = level_idx == l
        if bool(sel.any()):
            win[sel] = _patches(lev, rows[sel], cols[sel], R)
    # orientation over the radius-15 disc of the unblurred window
    off = torch.arange(-HALF_PATCH, HALF_PATCH + 1, dtype=torch.float64, device=dev)
    dy, dx = torch.meshgrid(off, off, indexing="ij")
    disc = (dx * dx + dy * dy) <= HALF_PATCH * HALF_PATCH
    c = win[:, R - HALF_PATCH:R + HALF_PATCH + 1, R - HALF_PATCH:R + HALF_PATCH + 1]
    m10 = torch.sum(c * torch.where(disc, dx, 0.0), dim=(1, 2))
    m01 = torch.sum(c * torch.where(disc, dy, 0.0), dim=(1, 2))
    angle = torch.atan2(m01, m10)
    # 7x7 Gaussian blur of the window -> [M, 39, 39] centred at SAMPLE_R
    g = _gauss7().to(dev)
    S = 2 * SAMPLE_R + 1
    v = sum(g[t] * win[:, t:t + S, :] for t in range(7))
    blurred = sum(g[t] * v[:, :, t:t + S] for t in range(7))
    # steered pattern at the quantised angle
    bins = torch.remainder(torch.round(angle * (N_BINS / (2.0 * math.pi))).to(torch.int64), N_BINS)
    th = 2.0 * math.pi * bins.to(torch.float64) / N_BINS
    ca, sa = torch.cos(th)[:, None, None], torch.sin(th)[:, None, None]
    pat = torch.from_numpy(PATTERN).to(dev).reshape(1, 256, 2, 2)  # (pair, point, xy)
    px, py = pat[..., 0], pat[..., 1]
    col = torch.clamp(torch.round(px * ca - py * sa).to(torch.int64) + SAMPLE_R, 0, S - 1)
    row = torch.clamp(torch.round(px * sa + py * ca).to(torch.int64) + SAMPLE_R, 0, S - 1)
    vals = blurred.reshape(M, S * S).gather(1, (row * S + col).reshape(M, 512)).reshape(M, 256, 2)
    vals = vals.to(values_dtype).to(torch.float64)
    bits = (vals[..., 0] < vals[..., 1]).to(torch.int64)
    words = torch.sum(bits.reshape(M, 8, 32) << torch.arange(32, device=dev), dim=-1)
    return angle, words


def hamming(a_words: torch.Tensor, b_words: torch.Tensor) -> torch.Tensor:
    """Per-row Hamming distance of packed descriptors [M, 8] (any integer
    type holding the 32-bit words)."""
    x = (a_words.to(torch.int64) ^ b_words.to(torch.int64)) & 0xFFFFFFFF
    bits = (x[..., None] >> torch.arange(32, device=x.device)) & 1
    return bits.sum(dim=(-1, -2))


def _run9(bits: torch.Tensor) -> torch.Tensor:
    """bits [16, ...] bool -> True where 9 circularly contiguous are set."""
    doubled = torch.cat([bits, bits[:8]], dim=0)
    run = torch.zeros(bits.shape[1:], dtype=torch.bool, device=bits.device)
    for k in range(16):
        run |= doubled[k:k + 9].all(dim=0)
    return run


def fast_scores(level: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9 score map of one level (0 for non-corners and where the
    circle does not fit)."""
    h, w = level.shape
    pad = torch.nn.functional.pad(level, (3, 3, 3, 3))
    diff = torch.stack([pad[3 + dy:3 + dy + h, 3 + dx:3 + dx + w] for dy, dx in CIRCLE]) - level
    bright = (torch.clamp(diff - threshold, min=0.0).sum(0), _run9(diff > threshold))
    dark = (torch.clamp(-diff - threshold, min=0.0).sum(0), _run9(diff < -threshold))
    score = torch.where(bright[1] | dark[1], torch.maximum(bright[0], dark[0]), 0.0)
    inside = torch.zeros_like(score, dtype=torch.bool)
    inside[3:h - 3, 3:w - 3] = True
    return torch.where(inside, score, 0.0)


def local_max(score: torch.Tensor) -> torch.Tensor:
    """True at positive scores >= each of their 8 neighbours."""
    pad = torch.nn.functional.pad(score, (1, 1, 1, 1))
    h, w = score.shape
    nmax = torch.stack([pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w] for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                        if dy or dx]).amax(0)
    return (score > 0) & (score >= nmax)


def keypoint_maps(levels, th_high: float, th_low: float):
    """Per level: (corner at the minimum threshold, a suppressed maximum of
    either threshold's score). A detector's keypoint passes where both
    hold (a cell falls back to the minimum threshold only where it has no
    corner at the initial one)."""
    maps = []
    for lev in levels:
        hi, lo = fast_scores(lev, th_high), fast_scores(lev, th_low)
        maps.append((lo > 0, local_max(hi) | local_max(lo)))
    return maps
