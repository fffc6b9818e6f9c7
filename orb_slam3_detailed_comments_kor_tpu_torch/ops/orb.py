"""Batched ORB feature extraction: pyramid FAST + orientation + rBRIEF.

Port of ``extract_orb_batch`` (and its tables) and the one-image
``extract_orb`` from
``orb_slam3_detailed_comments_kor_tpu/ops/orb.py``: an 8-level pyramid as
one padded stack [B·NL, Hp, Wp], FAST with the per-cell high/low fallback
(``cuda_fast``), per-cell selection, one [48,45] patch per keypoint
(``cuda_gather``), intensity-centroid orientation and the 7x7 blur as
matmuls, and rBRIEF sampled from the blurred patch at the keypoint's
steering bin. The constant tables are built by the reference's numpy code.
"""

from __future__ import annotations

import functools
import math
import os
from typing import List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from orb_slam3_detailed_comments_kor_tpu_torch.ops import cuda_fast
from orb_slam3_detailed_comments_kor_tpu_torch.ops import cuda_gather
from orb_slam3_detailed_comments_kor_tpu_torch.ops import fast as fast_ops
from orb_slam3_detailed_comments_kor_tpu_torch.ops import pyramid as pyr_ops
from orb_slam3_detailed_comments_kor_tpu_torch.ops import select as sel_ops

# the canonical ORB sampling pattern (bit_pattern_31_, Rublee et al. 2011)
_PATTERN = np.load(os.path.join(os.path.dirname(__file__), "orb_pattern.npy"))
HALF_PATCH = 15  # orientation patch radius (reference ORBextractor.cc:71)
BORDER = 19      # EDGE_THRESHOLD (reference ORBextractor.cc:72)

# One [48,45] unblurred patch per keypoint (rows r0-22..r0+25, cols
# c0-22..c0+22); orientation, the blur and rBRIEF all read it.
_PH, _PW, _PC = 48, 45, 22      # patch rows/cols and center index
_BLUR_T = 39                     # blurred interior size (+-19)
_N_BINS = 96                     # rBRIEF steering-angle bins (3.75 deg)


def _moment_weights() -> np.ndarray:
    """[_PH*_PW, 2] weights: m10/m01 over the centred 31x31 disc."""
    w = np.zeros((_PH, _PW, 2), np.float32)
    r = HALF_PATCH
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    circ = (dx * dx + dy * dy) <= r * r
    w[_PC - r:_PC + r + 1, _PC - r:_PC + r + 1, 0] = np.where(circ, dx, 0)
    w[_PC - r:_PC + r + 1, _PC - r:_PC + r + 1, 1] = np.where(circ, dy, 0)
    return w.reshape(_PH * _PW, 2)


def _blur_bands(ksize: int = 7, sigma: float = 2.0):
    """Band matrices (BR [_PH,_BLUR_T], BC [_PW,_BLUR_T]) of the separable
    Gaussian: blurred[u,v] = sum BR[i,u]*patch[i,j]*BC[j,v]."""
    x = np.arange(ksize) - (ksize - 1) / 2
    g = np.exp(-(x * x) / (2 * sigma * sigma)).astype(np.float32)
    g /= g.sum()
    br = np.zeros((_PH, _BLUR_T), np.float32)
    bc = np.zeros((_PW, _BLUR_T), np.float32)
    for u in range(_BLUR_T):
        for t in range(ksize):
            br[u + t, u] = g[t]
            bc[u + t, u] = g[t]
    return br, bc


def _bin_sample_lin() -> np.ndarray:
    """[_N_BINS, 512] linear indices into the [39,39] blurred patch: the
    rBRIEF pattern rotated by each bin's angle, rounded to pixels."""
    pat = _PATTERN.astype(np.float64)  # [256,4] x1 y1 x2 y2
    px = np.stack([pat[:, 0], pat[:, 2]], -1)  # [256,2]
    py = np.stack([pat[:, 1], pat[:, 3]], -1)
    out = np.zeros((_N_BINS, 512), np.int32)
    c = _BLUR_T // 2  # 19
    for b in range(_N_BINS):
        th = 2.0 * np.pi * b / _N_BINS
        ca, sa = np.cos(th), np.sin(th)
        col = np.clip(np.round(px * ca - py * sa).astype(np.int64) + c, 0, _BLUR_T - 1)
        row = np.clip(np.round(px * sa + py * ca).astype(np.int64) + c, 0, _BLUR_T - 1)
        out[b] = (row * _BLUR_T + col).reshape(-1)  # s = 2*j + t
    return out


_W_MOM = _moment_weights()
_BR, _BC = _blur_bands()
_BIN_LIN = _bin_sample_lin()


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """The constant tables on ``device`` (one copy per device)."""
    to = lambda a: torch.from_numpy(a).to(device)
    return to(_W_MOM), to(_BR), to(_BC), to(_BIN_LIN.astype(np.int64))


class Features(NamedTuple):
    """Fixed-capacity feature set for one image. All tensors length N."""

    xy: torch.Tensor        # [N,2] float32, level-0 pixel coords (x, y)
    response: torch.Tensor  # [N] float32
    angle: torch.Tensor     # [N] float32 radians
    level: torch.Tensor     # [N] int32 pyramid level
    desc: torch.Tensor      # [N,256] uint8 in {0,1}
    valid: torch.Tensor     # [N] bool

    @property
    def n(self) -> int:
        return self.xy.shape[0]


def level_budgets(n_features: int, n_levels: int, scale: float) -> List[int]:
    """Per-level feature budgets, geometric in 1/scale."""
    f = 1.0 / scale
    base = n_features * (1 - f) / (1 - f ** n_levels)
    budgets = [int(round(base * f ** l)) for l in range(n_levels - 1)]
    budgets.append(max(n_features - sum(budgets), 0))
    return budgets


def pack_descriptors(bits: torch.Tensor) -> torch.Tensor:
    """[...,256] {0,1} -> [...,8] int32 bit patterns of the reference's
    uint32 words (little-endian bit order; torch has no uint32 shifts)."""
    b = bits.reshape(*bits.shape[:-1], 8, 32).to(torch.int64)
    shifts = torch.arange(32, device=bits.device)
    return torch.sum(b << shifts, dim=-1).to(torch.int32)


def unpack_descriptors(packed: torch.Tensor) -> torch.Tensor:
    """[...,8] int32 -> [...,256] {0,1} uint8."""
    shifts = torch.arange(32, device=packed.device, dtype=torch.int32)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], 256).to(torch.uint8)


@functools.lru_cache(maxsize=None)
def _slot_layout(n_features: int, n_levels: int, scale: float,
                 device: torch.device):
    """Static compaction: level l keeps its first budgets[l] slots.
    Returns (K0, sel_idx [N], level [N] int32, sigma [N] f32) on device."""
    budgets = level_budgets(n_features, n_levels, scale)
    K0 = max(budgets)
    sel_idx = np.concatenate([l * K0 + np.arange(b) for l, b in enumerate(budgets)])
    lvl = np.concatenate([np.full(b, l, np.int32) for l, b in enumerate(budgets)])
    sigma = (scale ** lvl).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(device)
    return K0, to(sel_idx), to(lvl), to(sigma)


def extract_orb_batch(
    imgs: torch.Tensor,
    n_features: int = 1200,
    n_levels: int = 8,
    scale: float = 1.2,
    ini_th: float = 20.0,
    min_th: float = 7.0,
    cell: int = 32,
    return_stack: bool = False,
):
    """ORB extraction for a batch of images [B,H,W] float32 (0..255).

    Returns Features with leading batch dim [B, N, ...]; with
    return_stack=True also the padded level stack [B, NL, Hp, Wp] and the
    keypoint-centred patches [B·N, 48, 45].
    """
    B, H, W = imgs.shape
    shapes = pyr_ops.level_shapes(H, W, n_levels, scale)
    levels = [imgs]
    for l in range(1, n_levels):
        levels.append(pyr_ops.resize_matmul(levels[-1], shapes[l][0], shapes[l][1]))
    # width padded to a multiple of 128 and height to 8, as the reference
    Hp = ((H + 7) // 8) * 8
    Wp = ((W + 127) // 128) * 128
    stack = torch.stack(
        [F.pad(lv, (0, Wp - s[1], 0, Hp - s[0])) for lv, s in zip(levels, shapes)],
        dim=1,
    )  # [B,NL,Hp,Wp]
    feats, patches = features_from_stack(
        stack, shapes, n_features, scale, ini_th, min_th, cell
    )
    if return_stack:
        return feats, stack, patches
    return feats


def extract_orb(
    img: torch.Tensor,
    n_features: int = 1200,
    n_levels: int = 8,
    scale: float = 1.2,
    ini_th: float = 20.0,
    min_th: float = 7.0,
    cell: int = 32,
) -> Features:
    """ORB extraction for one grayscale image [H,W] float32 (0..255):
    ``extract_orb_batch`` on a batch of one. Returns Features with N = the
    sum of the level budgets."""
    feats = extract_orb_batch(
        img[None], n_features=n_features, n_levels=n_levels, scale=scale,
        ini_th=ini_th, min_th=min_th, cell=cell,
    )
    return Features(*(a[0] for a in feats))


def features_from_stack(stack, shapes, n_features: int, scale: float,
                        ini_th: float, min_th: float, cell: int):
    """Everything of ``extract_orb_batch`` after the pyramid: stack
    [B,NL,Hp,Wp] and the true level shapes -> (Features [B,N,...],
    patches [B·N,48,45])."""
    B, NL, Hp, Wp = stack.shape
    dev = stack.device
    flat = stack.reshape(B * NL, Hp, Wp)
    hs = tuple(s[0] for s in shapes)
    ws = tuple(s[1] for s in shapes)
    K0, sel_idx, lvl, sig = _slot_layout(n_features, NL, scale, dev)
    N = sel_idx.shape[0]

    # ---- FAST + NMS + high/low fallback, whole stack at once ------------
    score, raw_lo = cuda_fast.fast_nms_stack(flat, hs, ws, NL, ini_th, min_th, cell)
    inbB = fast_ops.level_interior(hs, ws, BORDER, Hp, Wp, dev)
    score = torch.where(inbB.expand(B, NL, Hp, Wp).reshape(B * NL, Hp, Wp), score, 0.0)

    # ---- spatially-uniform selection (K0 slots per level) ---------------
    xyf, respf, validf = sel_ops.select_keypoints(score, K0, cell=cell, border=0)
    xy = xyf.reshape(B, NL * K0, 2)[:, sel_idx]      # [B,N,2] level-local int
    resp = respf.reshape(B, NL * K0)[:, sel_idx]
    valid = validf.reshape(B, NL * K0)[:, sel_idx]

    # ---- one [48,45] patch per keypoint, then dense algebra -------------
    flat_idx = (torch.arange(B, device=dev)[:, None] * NL + lvl[None]).reshape(B * N)
    xk = xy[..., 0].reshape(B * N)
    yk = xy[..., 1].reshape(B * N)
    row0 = flat_idx * Hp + yk  # keypoint row in the [B*NL*Hp, Wp] flat image
    flat2d = flat.reshape(B * NL * Hp, Wp)
    patches = cuda_gather.gather_patches(flat2d, row0 - _PC, xk - _PC, _PH, _PW)

    w_mom, br, bc, bin_lin = _tables(dev)
    # orientation: intensity centroid as one moment matmul
    mom = patches.reshape(B * N, _PH * _PW) @ w_mom  # [K,2]
    ang = torch.atan2(mom[:, 1], mom[:, 0])
    # 7x7 Gaussian blur as two band matmuls -> [K,39,39] blurred interior
    blurred = torch.einsum("kiw,iu->kuw", patches, br)
    blurred = torch.einsum("kuw,wv->kuv", blurred, bc)
    # rBRIEF: compare bf16-rounded blurred pixels at the bin's sample pairs
    # (the reference's selection matmuls pick bf16 values)
    bins = torch.remainder(
        torch.round(ang * (_N_BINS / (2.0 * math.pi))).to(torch.int64), _N_BINS
    )
    blur_bf = blurred.reshape(B * N, _BLUR_T * _BLUR_T).to(torch.bfloat16)
    vals = torch.gather(blur_bf, 1, bin_lin[bins]).reshape(B * N, 256, 2)
    desc = (vals[..., 0] < vals[..., 1]).to(torch.uint8)

    # subpixel: separable parabola on the raw low-threshold response
    raw2d = raw_lo.reshape(B * NL * Hp, Wp)
    sc = raw2d[row0, xk]
    sl = raw2d[row0, xk - 1]
    sr = raw2d[row0, xk + 1]
    su = raw2d[row0 - 1, xk]
    sd = raw2d[row0 + 1, xk]

    def para(m, p, c):
        denom = m + p - 2.0 * c
        off = torch.where(torch.abs(denom) > 1e-6, 0.5 * (m - p) / denom, 0.0)
        return torch.clamp(off, -0.5, 0.5)

    sub = torch.stack([para(sl, sr, sc), para(su, sd, sc)], dim=-1)  # (dx,dy)
    feats = Features(
        xy=(xy.to(torch.float32) + sub.reshape(B, N, 2)) * sig[None, :, None],
        response=resp,
        angle=ang.reshape(B, N),
        level=lvl[None].expand(B, N),
        desc=torch.where(valid[..., None], desc.reshape(B, N, 256), 0).to(torch.uint8),
        valid=valid,
    )
    return feats, patches
