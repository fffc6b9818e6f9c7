"""Hamming-space data association.

Port of ``hamming_matrix``, ``masked_best2``, ``match_nn_ratio``,
``search_by_projection`` and ``resolve_duplicate_targets`` from
``orb_slam3_detailed_comments_kor_tpu/ops/matching.py``. The per-frame
matcher goes through the ``masked_best2`` kernel (``cuda_matching``);
``match_nn_ratio`` stays plain torch, as it is in the reference.
Thresholds mirror the reference: TH_LOW=50, TH_HIGH=100 of 256 bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

TH_LOW = 50
TH_HIGH = 100
BIG = 1e9


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """[N,256]x[M,256] {0,1} -> [N,M] float32 Hamming distances (exact:
    the popcount identity |a| + |b| - 2·a·b on 0/1 values)."""
    a = desc_a.to(torch.float32)
    b = desc_b.to(torch.float32)
    common = a @ b.T
    na = torch.sum(a, dim=1, keepdim=True)
    nb = torch.sum(b, dim=1, keepdim=True)
    return na + nb.T - 2.0 * common


class MatchResult(NamedTuple):
    idx: torch.Tensor    # [N] int32 best match in B for each A (or -1)
    dist: torch.Tensor   # [N] float32 best distance (BIG where invalid)
    valid: torch.Tensor  # [N] bool


def masked_best2(dist: torch.Tensor, mask: torch.Tensor):
    """Per-row best and second-best over masked columns.

    dist [N,M], mask [N,M] bool -> (best_idx [N] int32, best [N], second [N]).
    Ties take the first column, as jnp.argmin.
    """
    d = torch.where(mask, dist, BIG)
    best_idx = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, best_idx[:, None])[:, 0]
    d2 = d.scatter(1, best_idx[:, None], BIG)
    second = torch.amin(d2, dim=1)
    return best_idx.to(torch.int32), best, second


def match_nn_ratio(
    desc_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_a: torch.Tensor,
    valid_b: torch.Tensor,
    max_dist: float = TH_LOW,
    ratio: float = 0.9,
    mask: Optional[torch.Tensor] = None,
    mutual: bool = True,
) -> MatchResult:
    """Nearest-neighbour matching with distance + Lowe-ratio gates and an
    optional mutual check (SearchByBoW-style brute force). Descriptors are
    {0,1} bits [N,256] or packed int32 [N,8]."""
    from orb_slam3_detailed_comments_kor_tpu_torch.ops import orb as orb_ops

    bits = lambda d: orb_ops.unpack_descriptors(d) if d.shape[-1] == 8 else d
    dist = hamming_matrix(bits(desc_a), bits(desc_b))
    m = valid_a[:, None] & valid_b[None, :]
    if mask is not None:
        m = m & mask
    best_idx, best, second = masked_best2(dist, m)
    ok = (best <= max_dist) & (best <= ratio * second)
    if mutual:
        best_back = torch.argmin(torch.where(m, dist, BIG), dim=0)  # [M] best A per B
        ok = ok & (best_back[best_idx.to(torch.int64)]
                   == torch.arange(desc_a.shape[0], device=dist.device))
    ok = ok & valid_a
    return MatchResult(
        idx=torch.where(ok, best_idx, -1), dist=torch.where(ok, best, BIG), valid=ok
    )


def search_by_projection(
    proj_uv: torch.Tensor,
    proj_level: torch.Tensor,
    proj_desc: torch.Tensor,
    proj_valid: torch.Tensor,
    feat_xy: torch.Tensor,
    feat_level: torch.Tensor,
    feat_desc: torch.Tensor,
    feat_valid: torch.Tensor,
    radius: float,
    scale: float = 1.2,
    max_dist: float = TH_HIGH,
    ratio: float = 0.9,
    level_slack: int = 1,
) -> MatchResult:
    """Associate projected map points to frame features inside a radius
    window scaled by the predicted octave (``ORBmatcher::SearchByProjection``).

    proj_uv [L,2]; proj_level [L]; proj_desc [L,256] bits or [L,8] packed;
    feat_* are frame features [N,...] (descriptors in either layout).
    Returns per-map-point MatchResult into the frame features.
    """
    from orb_slam3_detailed_comments_kor_tpu_torch.ops import cuda_matching

    sigma = scale ** proj_level.to(torch.float32)  # [L]
    r = radius * sigma
    d2 = torch.sum((proj_uv[:, None, :] - feat_xy[None, :, :]) ** 2, dim=-1)
    in_window = d2 <= (r[:, None] ** 2)
    lvl_ok = torch.abs(feat_level[None, :] - proj_level[:, None]) <= level_slack
    m = in_window & lvl_ok & proj_valid[:, None] & feat_valid[None, :]
    best_idx, best, second = cuda_matching.fused_masked_best2(proj_desc, feat_desc, m)
    ok = (best <= max_dist) & (best <= ratio * second) & proj_valid
    return MatchResult(
        idx=torch.where(ok, best_idx, -1),
        dist=torch.where(ok, best, BIG),
        valid=ok,
    )


def resolve_duplicate_targets(res: MatchResult, n_targets: int) -> MatchResult:
    """Each target feature keeps at most one source: the closest, and on a
    distance tie the lowest source index."""
    n = res.idx.shape[0]
    dev = res.idx.device
    tgt = torch.where(res.valid, res.idx, n_targets).to(torch.int64)  # park invalid
    best_per_tgt = torch.full((n_targets + 1,), BIG, device=dev).scatter_reduce(
        0, tgt, res.dist, reduce="amin"
    )
    keep = res.valid & (res.dist <= best_per_tgt[tgt])
    src = torch.arange(n, device=dev)
    first_src = torch.full((n_targets + 1,), n, device=dev).scatter_reduce(
        0, tgt, torch.where(keep, src, n), reduce="amin"
    )
    keep = keep & (first_src[tgt] == src)
    return MatchResult(
        idx=torch.where(keep, res.idx, -1),
        dist=torch.where(keep, res.dist, BIG),
        valid=keep,
    )
