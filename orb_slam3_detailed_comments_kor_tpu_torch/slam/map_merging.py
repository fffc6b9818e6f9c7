"""Duplicate-landmark fusion.

Port of ``fuse_duplicate_landmarks`` from
``orb_slam3_detailed_comments_kor_tpu/slam/map_merging.py``, the one part
of map merging the stereo SLAM loop runs (on every new keyframe's spawns).
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam3_detailed_comments_kor_tpu_torch.ops import orb as orb_ops
from orb_slam3_detailed_comments_kor_tpu_torch.slam import map_state as msx


def fuse_duplicate_landmarks(
    ms: msx.MapState,
    src_is_new: torch.Tensor,
    radius: float = 0.05,
    max_hamming: int = 50,
):
    """SearchAndFuse analog in 3-D: a new landmark (``src_is_new`` [L])
    within ``radius`` of an original landmark with a matching descriptor is
    replaced by it (observations rewritten, counters accumulated).

    Returns (ms', number fused as a 0-d tensor). The nearest original
    landmark comes from squared distances summed per component in 1024-row
    blocks, as the reference computes them (an expanded |a|^2 + |b|^2 - 2ab
    product rounds differently and would move near-tie argmins); argmin
    takes the first minimum, as jnp.argmin.
    """
    L = ms.L
    old_mask = ms.lm_valid & ~src_is_new
    new_mask = ms.lm_valid & src_is_new
    pos = ms.lm_pos
    axes = pos.T.contiguous()  # [3, L]: one contiguous row per coordinate
    chunk = min(1024, L)
    nearest, near_d2 = [], []
    for c0 in range(0, L, chunk):
        d2 = None
        for a in axes:  # (dx² + dy²) + dz², the reference's order
            d = a[c0:c0 + chunk, None] - a[None, :]
            d2 = d * d if d2 is None else d2 + d * d
        d2 = torch.where(old_mask[None, :], d2, float("inf"))
        nb = torch.argmin(d2, dim=1)
        nearest.append(nb)
        near_d2.append(torch.gather(d2, 1, nb[:, None])[:, 0])
    nearest = torch.cat(nearest)
    # the reference squares its traced f32 radius in f32
    r2 = float(np.float32(radius) * np.float32(radius))
    near_ok = torch.cat(near_d2) < r2
    ham = torch.sum(
        orb_ops.unpack_descriptors(ms.lm_desc) != orb_ops.unpack_descriptors(ms.lm_desc[nearest]),
        dim=-1,
    )
    fuse = new_mask & near_ok & (ham <= max_hamming)
    # rewrite observations: fused new id -> old id (MapPoint::Replace)
    remap = torch.where(fuse, nearest, torch.arange(L, device=pos.device)).to(torch.int32)
    obs = torch.where(ms.obs_lm >= 0, remap[torch.clamp(ms.obs_lm, min=0).to(torch.int64)], -1)
    # found/visible counters accumulate onto the kept landmark
    lm_found = ms.lm_found.index_add(0, nearest, torch.where(fuse, ms.lm_found, 0))
    lm_visible = ms.lm_visible.index_add(0, nearest, torch.where(fuse, ms.lm_visible, 0))
    return ms._replace(
        lm_valid=ms.lm_valid & ~fuse,
        obs_lm=obs,
        lm_found=lm_found,
        lm_visible=lm_visible,
    ), torch.sum(fuse)
