"""Trajectory evaluation: Horn/Umeyama alignment + RMS ATE.

Re-implementation of the reference's offline scorer
(``evaluation/evaluate_ate_scale.py:50-120``): align the estimated
trajectory to ground truth with a closed-form similarity (rotation +
translation + optional scale) and report root-mean-square absolute
trajectory error.  numpy, host-side: the port's own copy of
``orb_slam3_detailed_comments_kor_tpu/eval/ate.py``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama_align(
    est: np.ndarray, gt: np.ndarray, with_scale: bool = False
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity aligning est -> gt. est/gt [T,3].

    Returns (R, t, s) with  gt ≈ s·R·est + t.
    """
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    xe = est - mu_e
    xg = gt - mu_g
    C = xg.T @ xe / est.shape[0]
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_e = (xe ** 2).sum() / est.shape[0]
        s = float(np.trace(np.diag(D) @ S) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return R, t, s


def ate_rmse(
    est: np.ndarray, gt: np.ndarray, with_scale: bool = False
) -> float:
    """RMS absolute trajectory error after alignment. est/gt [T,3] metres."""
    R, t, s = umeyama_align(est, gt, with_scale)
    aligned = (s * (R @ est.T)).T + t
    err = np.linalg.norm(aligned - gt, axis=1)
    return float(np.sqrt((err ** 2).mean()))


def associate_timestamps(
    t_est: np.ndarray, t_gt: np.ndarray, max_dt: float = 0.02
) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest-timestamp association (evaluation/associate.py analog).

    Returns index arrays (idx_est, idx_gt) of matched pairs.
    """
    idx_gt = np.searchsorted(t_gt, t_est)
    idx_gt = np.clip(idx_gt, 1, len(t_gt) - 1)
    left = t_gt[idx_gt - 1]
    right = t_gt[idx_gt]
    choose_left = (t_est - left) < (right - t_est)
    best = np.where(choose_left, idx_gt - 1, idx_gt)
    dt = np.abs(t_gt[best] - t_est)
    keep = dt <= max_dt
    return np.nonzero(keep)[0], best[keep]
