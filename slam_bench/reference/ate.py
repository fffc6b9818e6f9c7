"""Absolute trajectory error: Horn/Umeyama alignment and RMS error.

A frozen copy of the port's ``eval/ate.py`` arithmetic (itself after
ORB-SLAM3's ``evaluation/evaluate_ate_scale.py``), in NumPy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama_align(est: np.ndarray, gt: np.ndarray, with_scale: bool = False) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity with gt ≈ s·R·est + t; est, gt [T,3]."""
    mu_e, mu_g = est.mean(axis=0), gt.mean(axis=0)
    xe, xg = est - mu_e, gt - mu_g
    C = xg.T @ xe / est.shape[0]
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / ((xe ** 2).sum() / est.shape[0])) if with_scale else 1.0
    return R, mu_g - s * R @ mu_e, s


def ate_rmse(est: np.ndarray, gt: np.ndarray, with_scale: bool = False) -> float:
    """RMS distance after alignment; est, gt [T,3] in metres."""
    R, t, s = umeyama_align(est, gt, with_scale)
    err = np.linalg.norm((s * (R @ est.T)).T + t - gt, axis=1)
    return float(np.sqrt((err ** 2).mean()))
