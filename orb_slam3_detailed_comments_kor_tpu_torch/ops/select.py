"""Spatially-uniform keypoint selection on static shapes.

Port of ``select_keypoints`` from
``orb_slam3_detailed_comments_kor_tpu/ops/select.py``: the top-2 responses
of each cell form a candidate pool, and the global top-K of the pool fills
a fixed slot array with a validity mask. Batched over leading dims here
(the reference vmaps it over the level stack).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def select_keypoints(
    score: torch.Tensor,
    max_kps: int,
    cell: int,
    border: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """score [...,H,W] (0 = not a corner) -> (xy [...,K,2] int32 (x,y),
    resp [...,K], valid [...,K]).

    Invalid slots have resp=0, valid=False, xy=(0,0). Equal scores keep
    the lower pool index first, as ``jax.lax.top_k`` does: a stable
    descending sort, not ``torch.topk``, which promises no tie order.
    """
    *lead, h, w = score.shape
    dev = score.device
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    inb = (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)
    score = torch.where(inb, score, 0.0)

    ch = (h + cell - 1) // cell
    cw = (w + cell - 1) // cell
    pad = F.pad(score, (0, cw * cell - w, 0, ch * cell - h))
    cells = pad.reshape(*lead, ch, cell, cw, cell).transpose(-3, -2).reshape(
        *lead, ch, cw, cell * cell
    )
    # top-2 per cell (argmax takes the first index on ties, as jnp.argmax)
    best1 = cells.amax(dim=-1)
    idx1 = torch.argmax(cells, dim=-1)
    cells2 = cells.scatter(-1, idx1[..., None], float("-inf"))
    best2 = cells2.amax(dim=-1)
    idx2 = torch.argmax(cells2, dim=-1)

    cy = torch.arange(ch, device=dev)[:, None]
    cx = torch.arange(cw, device=dev)[None, :]

    def cell_to_xy(idx):
        return cx * cell + idx % cell, cy * cell + idx // cell

    x1, y1 = cell_to_xy(idx1)
    x2, y2 = cell_to_xy(idx2)
    flat = lambda a: a.reshape(*lead, ch * cw)
    pool_scores = torch.cat([flat(best1), flat(best2)], dim=-1)
    pool_x = torch.cat([flat(x1), flat(x2)], dim=-1)
    pool_y = torch.cat([flat(y1), flat(y2)], dim=-1)

    k = min(max_kps, pool_scores.shape[-1])
    top_scores, top_idx = torch.sort(pool_scores, dim=-1, descending=True, stable=True)
    top_scores, top_idx = top_scores[..., :k], top_idx[..., :k]
    sel_x = torch.gather(pool_x, -1, top_idx)
    sel_y = torch.gather(pool_y, -1, top_idx)
    valid = top_scores > 0.0
    if k < max_kps:
        padn = max_kps - k
        top_scores = F.pad(top_scores, (0, padn))
        sel_x = F.pad(sel_x, (0, padn))
        sel_y = F.pad(sel_y, (0, padn))
        valid = F.pad(valid, (0, padn))
    xy = torch.stack([sel_x, sel_y], dim=-1).to(torch.int32)
    xy = torch.where(valid[..., None], xy, 0)
    return xy, torch.where(valid, top_scores, 0.0), valid
