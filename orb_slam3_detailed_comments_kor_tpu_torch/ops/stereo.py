"""Rectified stereo matching: row-banded Hamming + SAD subpixel refine.

Port of ``orb_slam3_detailed_comments_kor_tpu/ops/stereo.py``, every
function of it: each left feature takes the best right feature within a
±2σ row band, ±1 level and [0, maxD] disparity by Hamming distance (the
``masked_best2`` kernel), then an 11x11 SAD slide over ±5 px plus one
Lucas-Kanade step refines the disparity at the feature's level, and a
median-SAD gate rejects outliers. Depth = bf / disparity; -1 where there is
none. The pyramids are either the extractor's padded level stacks, whose
levels sit at a fixed row pitch, or per-level lists (``pyramid.
build_pyramid``), whose ragged levels ``_stack_pyramid`` packs into one
atlas; either way the right strips come from the ``gather_patches``
kernel.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple

import torch

from orb_slam3_detailed_comments_kor_tpu_torch.ops import cuda_gather
from orb_slam3_detailed_comments_kor_tpu_torch.ops import cuda_matching
from orb_slam3_detailed_comments_kor_tpu_torch.ops import orb as orb_ops
from orb_slam3_detailed_comments_kor_tpu_torch.ops import pyramid as pyr_ops
from orb_slam3_detailed_comments_kor_tpu_torch.ops.matching import BIG, TH_HIGH
from orb_slam3_detailed_comments_kor_tpu_torch.ops.orb import Features

_W = 5      # SAD half-window (11x11)
_L = 5      # SAD slide range


class StereoDepth(NamedTuple):
    u_right: torch.Tensor  # [N] float32 matched right u at level 0 (-1 if none)
    depth: torch.Tensor    # [N] float32 (-1 if none)
    valid: torch.Tensor    # [N] bool


def _stack_pyramid(pyr: List[torch.Tensor]):
    """Pack the levels into one [ΣH_l, W0] atlas, each level's rows padded
    with zeros to level 0's width, and the levels' first rows (int32 [NL])."""
    w0 = pyr[0].shape[1]
    offs = [0]
    for img in pyr[:-1]:
        offs.append(offs[-1] + img.shape[0])
    atlas = torch.cat([torch.nn.functional.pad(img, (0, w0 - img.shape[1])) for img in pyr], dim=0)
    return atlas, torch.tensor(offs, dtype=torch.int32, device=atlas.device)


def _sad_refine_atlas(
    atlas_l,
    atlas_r: torch.Tensor,
    row_off: torch.Tensor,
    level_w: torch.Tensor,
    level_h: torch.Tensor,
    level: torch.Tensor,
    xl: torch.Tensor,
    yl: torch.Tensor,
    xr0: torch.Tensor,
    left_patches=None,
):
    """SAD + LK subpixel for all keypoints at once; level-local coords.

    The right strips are one ``gather_patches`` call on ``atlas_r`` (their
    corners lie inside it, so its clamp never moves them). With
    ``left_patches`` (the extractor's keypoint-centred [K,48,45] patches)
    the left 11x11 windows are cropped from them; without, they come from
    ``atlas_l`` by advanced indexing. Returns (du [K], sad [K], xi [K]).
    """
    win = 2 * _W + 1
    w_l = level_w[level]
    h_l = level_h[level]
    yi = torch.clamp(torch.round(yl).to(torch.int32), _W, None)
    yi = torch.minimum(yi, h_l - _W - 1)
    xi = torch.minimum(torch.clamp(torch.round(xl).to(torch.int32), _W, None), w_l - _W - 1)
    xri = torch.minimum(
        torch.clamp(torch.round(xr0).to(torch.int32), _W + _L, None), w_l - _W - _L - 1
    )
    base = row_off[level] + yi  # atlas row of the kp

    strip_r = cuda_gather.gather_patches(atlas_r, base - _W, xri - _W - _L, win, win + 2 * _L)  # [K,win,win+2L]
    if left_patches is not None:
        pc = orb_ops._PC
        patch_l = left_patches[:, pc - _W:pc + _W + 1, pc - _W:pc + _W + 1]
    else:
        dev = atlas_l.device
        rows = (base[:, None, None] + torch.arange(-_W, _W + 1, device=dev)[None, :, None]).to(torch.int64)
        dxl = torch.arange(-_W, _W + 1, device=dev)[None, None, :]
        patch_l = atlas_l[rows, (xi[:, None, None] + dxl).to(torch.int64)]  # [K,win,win]
    patch_l_n = patch_l - patch_l[:, _W, _W][:, None, None]
    sads = []
    for i in range(2 * _L + 1):
        wnd = strip_r[:, :, i:i + win]
        wnd = wnd - wnd[:, _W, _W][:, None, None]
        sads.append(torch.sum(torch.abs(wnd - patch_l_n), dim=(1, 2)))
    sads = torch.stack(sads, dim=1)  # [K, 11]
    best = torch.argmin(sads, dim=1)
    s0 = torch.gather(sads, 1, best[:, None])[:, 0]
    # subpixel: one Lucas-Kanade step on the best-aligned raw window
    # (a parabola on SAD samples pixel-locks; see the reference)
    wnd_best = torch.gather(
        strip_r, 2,
        (best[:, None, None] + torch.arange(win, device=best.device)).expand(-1, win, -1),
    )
    gx = 0.5 * (wnd_best[:, :, 2:] - wnd_best[:, :, :-2])  # [K,win,win-2]
    diff = (patch_l - wnd_best)[:, :, 1:-1]
    num = torch.sum(gx * diff, dim=(1, 2))
    den = torch.sum(gx * gx, dim=(1, 2))
    delta = torch.where(den > 1e-6, num / torch.clamp(den, min=1e-6), 0.0)
    delta = torch.clamp(delta, -1.0, 1.0)
    du = (best - _L).to(torch.float32) + delta + (xri.to(torch.float32) - xr0)
    return du, s0, xi


@functools.lru_cache(maxsize=None)
def _level_extents(lvl_hw: tuple, device: torch.device):
    """(level_h, level_w) int32 [NL] on device, built once per shape."""
    h = torch.tensor([s[0] for s in lvl_hw], dtype=torch.int32, device=device)
    w = torch.tensor([s[1] for s in lvl_hw], dtype=torch.int32, device=device)
    return h, w


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """jnp.nanmedian: the mean of the two middle values for an even count
    (torch.nanmedian returns the lower one), NaN when all are NaN."""
    srt = torch.sort(x).values  # NaNs sort last
    n = torch.sum(~torch.isnan(x)).to(torch.float32)
    pos = 0.5 * (n - 1.0)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    hw = pos - lo
    # index with a 1-element tensor: a 0-d index would be read to the host
    get = lambda p: srt[torch.clamp(p, min=0).to(torch.int64).reshape(1)][0]
    med = get(lo) * (1.0 - hw) + get(hi) * hw
    return torch.where(n > 0, med, float("nan"))


def compute_stereo_matches(
    left: Features,
    right: Features,
    pyr_l,
    pyr_r,
    bf: float,
    scale: float = 1.2,
    max_row_slack: float = 2.0,
    level_hw=None,
    left_patches=None,
) -> StereoDepth:
    """Stereo over fixed-capacity feature sets.

    pyr_l / pyr_r: either per-level lists of [H_l, W_l] images
    (``pyramid.build_pyramid``) or the padded level stacks [NL,Hp,Wp] from
    ``extract_orb_batch``, with ``level_hw`` the true per-level shapes
    (default: ``level_shapes`` of the stack); ``left_patches`` optionally
    the extractor's left-view patches.
    """
    ragged = isinstance(pyr_l, (list, tuple))
    if ragged:
        lvl_hw = [(p.shape[0], p.shape[1]) for p in pyr_l]
    else:
        lvl_hw = level_hw or pyr_ops.level_shapes(pyr_l.shape[1], pyr_l.shape[2], pyr_l.shape[0], scale)
    dev = left.xy.device
    # --- stage 1: banded Hamming match ----------------------------------
    sigma_l = scale ** left.level.to(torch.float32)
    row_gap = torch.abs(left.xy[:, 1:2] - right.xy[None, :, 1])
    row_ok = row_gap <= (max_row_slack * sigma_l[:, None])
    lvl_ok = torch.abs(left.level[:, None] - right.level[None, :]) <= 1
    disp = left.xy[:, 0:1] - right.xy[None, :, 0]
    max_disp = bf / 0.3  # maxD = bf / minZ with minZ = 0.3 m
    disp_ok = (disp > 0.0) & (disp < max_disp)
    mask = row_ok & lvl_ok & disp_ok & left.valid[:, None] & right.valid[None, :]
    # packed once per view, so the matcher's wrapper hands them straight in
    best_idx, best, _ = cuda_matching.fused_masked_best2(
        orb_ops.pack_descriptors(left.desc), orb_ops.pack_descriptors(right.desc), mask
    )
    matched = (best <= TH_HIGH) & left.valid
    xr_match = right.xy[best_idx.to(torch.int64), 0]  # [N] level-0 right u

    # --- stage 2: SAD subpixel at each feature's own level ---------------
    if ragged:
        atlas_l, row_off = _stack_pyramid(pyr_l)
        atlas_r, _ = _stack_pyramid(pyr_r)
    else:
        nl, hh, ww = pyr_l.shape
        atlas_l = pyr_l.reshape(nl * hh, ww)
        atlas_r = pyr_r.reshape(nl * hh, ww)
        row_off = torch.arange(nl, dtype=torch.int32, device=dev) * hh
    level_h, level_w = _level_extents(tuple(map(tuple, lvl_hw)), dev)
    lvl = left.level.to(torch.int64)
    # the reference divides by scale ** level; XLA rewrites a / b ** c as
    # a * b ** -c, and the level coordinates of corners whose subpixel
    # offset is clamped to ±0.5 sit on the rounding boundary of the SAD
    # window, so the port multiplies as the compiled reference does
    inv_sigma_l = scale ** (-left.level.to(torch.float32))
    du_lvl, sad_all, xi_lvl = _sad_refine_atlas(
        atlas_l, atlas_r, row_off, level_w, level_h, lvl,
        left.xy[:, 0] * inv_sigma_l, left.xy[:, 1] * inv_sigma_l, xr_match * inv_sigma_l,
        left_patches=left_patches,
    )
    du_all = du_lvl * sigma_l
    # disparity from the ROUNDED level coordinate the SAD window sat at,
    # re-expressed at the subpixel left u (see the reference)
    u_right_raw = xr_match + du_all
    disparity = xi_lvl.to(torch.float32) * sigma_l - u_right_raw
    u_right = left.xy[:, 0] - disparity
    ok = matched & (disparity > 0.01) & (disparity < max_disp)

    # --- stage 3: median SAD outlier gate (1.5*1.4*median) ---------------
    med = _nanmedian(torch.where(ok, sad_all, float("nan")))
    med = torch.where(torch.isnan(med), BIG, med)
    ok = ok & (sad_all <= 1.5 * 1.4 * med)

    depth = torch.where(ok, bf / torch.clamp(disparity, min=1e-6), -1.0)
    return StereoDepth(u_right=torch.where(ok, u_right, -1.0), depth=depth, valid=ok)
