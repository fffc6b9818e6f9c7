"""FAST-9/16 corner detection as dense tensor ops — the plain version of
the ``fast_nms`` kernel (``cuda_fast.py``).

Port of ``orb_slam3_detailed_comments_kor_tpu/ops/fast.py``, every
function of it: the 16 circle neighbours are rolled views, the
>=9-contiguous arc test is a shift-AND on an int32 bitfield (or, in
``_has_contiguous_run``, on a 16-wide boolean axis), the score is the sum
of margins beyond the threshold of the winning polarity, and NMS is a 3x3
max comparison. The reference's ``fast_with_fallback_stack`` is split in
two here: ``fast_nms_maps`` (what the kernel computes) and
``cell_fallback`` (what stays around it). ``cuda_fast.fast_nms_stack``
composes them around the kernel; ``fast_with_fallback_stack`` composes
them under the reference's name and arguments, as the plain path the
kernel is held against. ``fast_score`` and ``fast_with_fallback`` are the
reference's single-image FAST.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3: 16 (dy, dx) offsets, clockwise from 12
# o'clock (the circle OpenCV uses).
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """result[...,y,x] = img[...,y+dy, x+dx] (circular; callers mask the
    3-px border)."""
    return torch.roll(img, shifts=(-dy, -dx), dims=(-2, -1))


def _has_contiguous_run(mask16: torch.Tensor) -> torch.Tensor:
    """mask16 [...,16] bool -> bool, True iff a circular run of >=9 ones
    (iterated AND of rotations: runs of 2, 4, 8, then 9)."""
    r = mask16
    r = r & torch.roll(r, -1, dims=-1)   # runs of 2
    r = r & torch.roll(r, -2, dims=-1)   # 4
    r = r & torch.roll(r, -4, dims=-1)   # 8
    r = r & torch.roll(mask16, -8, dims=-1)  # 9
    return torch.any(r, dim=-1)


def _run9_bits(m: torch.Tensor) -> torch.Tensor:
    """m int32 with the 16 circle comparisons in bits 0-15 -> True iff some
    circular run of >=9 consecutive bits is set (AND-shift doubling on the
    doubled 32-bit window)."""
    mm = m | (m << 16)
    r = mm & (mm >> 1)    # runs of 2
    r = r & (r >> 2)      # 4
    r = r & (r >> 4)      # 8
    r = r & (mm >> 8)     # 9
    return (r & 0xFFFF) != 0


def fast_scores_two(img: torch.Tensor, th_high: float, th_low: float):
    """Dense FAST-9 responses at both thresholds, [...,H,W] each, 0 for
    non-corners; no border masking (the caller masks). Margins are summed
    in circle order k = 0..15, as the kernel does."""
    zi = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    bits_bh, bits_dh, bits_bl, bits_dl = zi, zi, zi, zi
    mb_h = torch.zeros_like(img)
    md_h, mb_l, md_l = mb_h, mb_h, mb_h
    for k, (dy, dx) in enumerate(CIRCLE_OFFSETS):
        diff = _shift(img, dy, dx) - img
        bits_bh = bits_bh | ((diff > th_high).to(torch.int32) << k)
        bits_dh = bits_dh | ((diff < -th_high).to(torch.int32) << k)
        bits_bl = bits_bl | ((diff > th_low).to(torch.int32) << k)
        bits_dl = bits_dl | ((diff < -th_low).to(torch.int32) << k)
        mb_h = mb_h + torch.clamp(diff - th_high, min=0.0)
        md_h = md_h + torch.clamp(-diff - th_high, min=0.0)
        mb_l = mb_l + torch.clamp(diff - th_low, min=0.0)
        md_l = md_l + torch.clamp(-diff - th_low, min=0.0)
    corner_h = _run9_bits(bits_bh) | _run9_bits(bits_dh)
    corner_l = _run9_bits(bits_bl) | _run9_bits(bits_dl)
    score_h = torch.where(corner_h, torch.maximum(mb_h, md_h), 0.0)
    score_l = torch.where(corner_l, torch.maximum(mb_l, md_l), 0.0)
    return score_h, score_l


def fast_score_raw(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Dense FAST-9 response without border masking, [...,H,W] -> [...,H,W]
    (the 3-px border holds rolled values; the caller masks it): the
    high-threshold map of ``fast_scores_two``, whose operations per
    threshold are the reference's here."""
    return fast_scores_two(img, threshold, threshold)[0]


def fast_score(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Dense FAST-9 corner response of one image [H,W]: 0 for non-corners
    and within 3 px of the border, else the larger polarity's sum of
    margins beyond the threshold."""
    score = fast_score_raw(img, threshold)
    h, w = img.shape
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    inb = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return torch.where(inb, score, 0.0)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep only positive local maxima over a 3x3 window (a pixel survives
    when it is >= every neighbour)."""
    nmax = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            n = _shift(score, dy, dx)
            nmax = n if nmax is None else torch.maximum(nmax, n)
    return torch.where((score >= nmax) & (score > 0), score, 0.0)


@functools.lru_cache(maxsize=None)
def level_interior(hs: tuple, ws: tuple, border: int, Hp: int, Wp: int,
                   device: torch.device) -> torch.Tensor:
    """[NL, Hp, Wp] bool: pixels at least ``border`` px inside each level's
    true (hs[l], ws[l]) extent within the padded stack. Built once per
    shape and device."""
    yy = torch.arange(Hp, device=device)[None, :, None]
    xx = torch.arange(Wp, device=device)[None, None, :]
    h = torch.tensor(hs, device=device)[:, None, None]
    w = torch.tensor(ws, device=device)[:, None, None]
    return (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)


def fast_nms_maps(flat: torch.Tensor, th_high: float, th_low: float,
                  inb: torch.Tensor):
    """FAST at both thresholds, masked to ``inb``, then 3x3 NMS.

    flat [B,H,W]; inb [B,H,W] bool. Returns (s_hi, s_lo, raw_lo): the NMS'd
    high and low maps and the masked pre-NMS low response — exactly the
    three outputs of the ``fast_nms`` kernel.
    """
    raw_hi, raw_lo = fast_scores_two(flat, th_high, th_low)
    raw_lo = torch.where(inb, raw_lo, 0.0)
    s_hi = nms3x3(torch.where(inb, raw_hi, 0.0))
    s_lo = nms3x3(raw_lo)
    return s_hi, s_lo, raw_lo


def cell_fallback(s_hi: torch.Tensor, s_lo: torch.Tensor, cell: int):
    """Per-cell high→low fallback (ORBextractor.cc:808-838): each
    cell x cell block keeps the high map if it has any corner there, else
    the low map."""
    b, h, w = s_hi.shape
    ch = (h + cell - 1) // cell
    cw = (w + cell - 1) // cell
    pad_hi = F.pad(s_hi, (0, cw * cell - w, 0, ch * cell - h))
    has_hi = pad_hi.reshape(b, ch, cell, cw, cell).amax(dim=(2, 4)) > 0
    use_hi = has_hi.repeat_interleave(cell, dim=1).repeat_interleave(
        cell, dim=2
    )[:, :h, :w]
    return torch.where(use_hi, s_hi, s_lo)


def fast_with_fallback_stack(flat: torch.Tensor, th_high: float, th_low: float, cell: int,
                             inb: torch.Tensor):
    """Batched high→low fallback over a level stack: the plain path of
    ``cuda_fast.fast_nms_stack``.

    flat [B,H,W] (padded level images); inb [B,H,W] bool masks each level's
    true interior. Returns (score [B,H,W], raw_lo [B,H,W]): the NMS'd
    per-cell fallback score and the pre-NMS low-threshold response.
    """
    s_hi, s_lo, raw_lo = fast_nms_maps(flat, th_high, th_low, inb)
    return cell_fallback(s_hi, s_lo, cell), raw_lo


def fast_with_fallback(img: torch.Tensor, th_high: float, th_low: float, cell: int) -> torch.Tensor:
    """One image [H,W]: FAST at the high threshold per cell, the low one in
    cells without a high-threshold corner (ORBextractor.cc:808-838), each
    map NMS'd."""
    s_hi = nms3x3(fast_score(img, th_high))
    s_lo = nms3x3(fast_score(img, th_low))
    return cell_fallback(s_hi[None], s_lo[None], cell)[0]
