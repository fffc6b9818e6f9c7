"""The comparisons that decide ``correct``, and the control's readings.

Every function takes plain arrays: what the program produced (poses,
keyframe features and their stereo matches, the map's landmarks and
observations, the stored IMU preintegration) and what the benchmark made
itself from the seed (images, ground-truth poses, IMU samples, the scene).
Nothing here imports the program; the reference works out again what the
program derived, from the benchmark's own inputs.

Numbers compared (each against a limit of the cell's, see PERF.md):

- ``ate_mm``: RMS distance of the window's frame positions from the
  ground truth after a rigid (no scale) Umeyama alignment;
- ``kp_bad_pct``: the share of the window's keyframes' keypoints that are
  not a FAST-9 corner at the minimum threshold and a suppressed maximum of
  the reference detector (``reference/orb.py``) at their level
  coordinates, on the worst pyramid level;
- ``desc_bits``: the median Hamming distance of those keypoints'
  descriptors from the reference rBRIEF at the same keypoints, on the
  worst pyramid level;
- ``reproj_px``: median reprojection residual (left u, v and right u) of
  the landmarks the window's keyframes observe, projected by the
  keyframes' poses;
- ``ba_gap_pct``: the median distance, in per cent of depth, of those
  landmarks from the bundle-adjustment optimum of their observations with
  the keyframe poses held (``ba_gaps``): a map that bundle adjustment
  never refined lies a stereo triangulation's error away;
- ``preint_rel_err`` (inertial configurations): the worst relative error
  of the window keyframes' stored ΔV and ΔP against float64 integration
  of the same samples at the true bias (zero: the samples are exact), so
  that a bias estimate of the program's cannot absorb a fault.

Read but not compared (no control reads three times the program's):
``depth_err_pct``, the median relative error of those features' stereo
depths bf / (u - u_right) against the scene's depth along their rays.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from slam_bench.reference import ate as ate_ref
from slam_bench.reference import orb as orb_ref
from slam_bench.reference import synthetic


def ate_mm(est_centres: np.ndarray, gt_centres: np.ndarray) -> float:
    return 1e3 * ate_ref.ate_rmse(np.asarray(est_centres, np.float64), np.asarray(gt_centres, np.float64))


def keyframe_held(frames: np.ndarray, kf_frames: np.ndarray, first: int) -> np.ndarray:
    """The control's frame for each of ``frames``: the latest keyframe
    frame at or before it (``first`` before any), i.e. a system that
    answers every frame with its keyframe's pose."""
    kfs = np.unique(np.concatenate([[first], np.asarray(kf_frames, np.int64)]))
    return kfs[np.searchsorted(kfs, frames, side="right") - 1]


# --- stereo depth ----------------------------------------------------------
def ray_depths(cam: dict, R_wc: np.ndarray, t_wc: np.ndarray, xy: np.ndarray, device) -> np.ndarray:
    """Scene depth along camera z at the features' level-0 coordinates
    ``xy`` [M,2] of one view (the renderer's pixel centres are at +0.5)."""
    params = torch.tensor([cam["fx"], cam["fy"], cam["cx"], cam["cy"]], dtype=torch.float64, device=device)
    scene = synthetic.default_scene(device)
    uv = torch.from_numpy(np.asarray(xy, np.float64) + 0.5).to(device)
    z = synthetic.ray_depth(params, torch.from_numpy(np.asarray(R_wc, np.float64)).to(device),
                            torch.from_numpy(np.asarray(t_wc, np.float64)).to(device), scene, uv)
    return z.cpu().numpy()


def depth_rel_errors(x: np.ndarray, ur: np.ndarray, bf: float, z_gt: np.ndarray) -> np.ndarray:
    ok = (ur >= 0) & (x - ur > 1e-6) & (z_gt > 0)
    z = bf / (x[ok] - ur[ok])
    return np.abs(z - z_gt[ok]) / z_gt[ok]


def integer_disparity_ur(x: np.ndarray, bf: float, z_gt: np.ndarray) -> np.ndarray:
    """The control's right-image coordinates: the true disparity rounded to
    whole pixels (the sub-pixel refinement left out)."""
    d = np.where(z_gt > 0, bf / np.where(z_gt > 0, z_gt, 1.0), 0.0)
    return np.where(z_gt > 0, x - np.maximum(np.round(d), 1.0), -1.0)


# --- descriptors -----------------------------------------------------------
def level_rows_cols(xy: np.ndarray, level: np.ndarray, scale: float):
    """Integer level coordinates of level-0 keypoints: xy = (k + sub)·s^l
    with |sub| ≤ 0.5."""
    sig = (scale ** level.astype(np.float64)).astype(np.float32).astype(np.float64)
    return (np.round(xy[:, 1] / sig).astype(np.int64), np.round(xy[:, 0] / sig).astype(np.int64))


def reference_pyramid(img: np.ndarray, orb: dict, device):
    return orb_ref.pyramid(torch.from_numpy(np.asarray(img)).to(device), orb["n_levels"], orb["scale_factor"])


def reference_descriptors(levels, xy: np.ndarray, level: np.ndarray, orb: dict,
                          values_dtype=torch.bfloat16) -> np.ndarray:
    """[M,8] packed reference descriptors at the keypoints of one image's
    reference pyramid ``levels``."""
    device = levels[0].device
    rows, cols = level_rows_cols(xy, level, orb["scale_factor"])
    to = lambda a: torch.from_numpy(a).to(device)
    _, words = orb_ref.describe(levels, to(level.astype(np.int64)), to(rows), to(cols), values_dtype)
    return words.cpu().numpy()


def keypoint_faults(maps, xy: np.ndarray, level: np.ndarray, scale: float) -> np.ndarray:
    """[M] True where a keypoint is not a FAST corner at the minimum
    threshold and a suppressed maximum (``orb.keypoint_maps``) at its level
    coordinates; where its sub-pixel offset lies within 0.01 px of half a
    pixel, either neighbouring pixel may hold it."""
    sig = (scale ** level.astype(np.float64)).astype(np.float32).astype(np.float64)
    fy, fx = xy[:, 1] / sig, xy[:, 0] / sig
    bad = np.ones(len(xy), bool)
    for l in np.unique(level):
        sel = level == l
        good = (maps[int(l)][0] & maps[int(l)][1]).cpu().numpy()
        h, w = good.shape
        for dr in (0.49, 0.51):
            for dc in (0.49, 0.51):
                r = np.clip(np.floor(fy[sel] + dr).astype(np.int64), 0, h - 1)
                c = np.clip(np.floor(fx[sel] + dc).astype(np.int64), 0, w - 1)
                bad[sel] &= ~good[r, c]
    return bad


def unsuppressed_keypoints(maps, counts: dict, scale: float, rng: np.random.Generator):
    """The control's keypoints: at each level, ``counts[level]`` FAST
    corners at the minimum threshold drawn from all of them inside the
    border, the non-maximum suppression left out. (xy [M,2] level-0,
    level [M])."""
    xy, lv = [], []
    for l, n in sorted(counts.items()):
        corner = maps[l][0].cpu().numpy()
        h, w = corner.shape
        b = orb_ref.BORDER
        rr, cc = np.nonzero(corner[b:h - b, b:w - b])
        if not len(rr):
            continue
        pick = rng.choice(len(rr), size=min(n, len(rr)), replace=False)
        sig = np.float64(np.float32(scale ** l))
        xy.append(np.stack([(cc[pick] + b) * sig, (rr[pick] + b) * sig], axis=-1))
        lv.append(np.full(len(pick), l))
    return np.concatenate(xy), np.concatenate(lv)


def worst_level(values: np.ndarray, level: np.ndarray, stat, min_count: int = 20) -> Optional[float]:
    """``stat`` of ``values`` on each level with at least ``min_count``
    of them, the worst (largest) over the levels."""
    per = [stat(values[level == l]) for l in np.unique(level) if np.sum(level == l) >= min_count]
    return float(max(per)) if per else None


def hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return orb_ref.hamming(torch.from_numpy(np.asarray(a, np.int64)), torch.from_numpy(np.asarray(b, np.int64))).numpy()


# --- map -------------------------------------------------------------------
def reprojection_residuals(cam: dict, bf: float, R_cw: np.ndarray, t_cw: np.ndarray, X_w: np.ndarray,
                           xy: np.ndarray, ur: np.ndarray, half_pixel: float = 0.0) -> np.ndarray:
    """Residual norm (left u, v; right u where the feature has a stereo
    match) of points X_w [M,3] in the camera (R_cw, t_cw) [M,3,3] / [M,3]
    against their observations. ``half_pixel`` = 0.5 projects in the
    renderer's pixel-centre convention (the reference map)."""
    Xc = np.einsum("mij,mj->mi", R_cw, X_w) + t_cw
    z = np.where(np.abs(Xc[:, 2]) > 1e-9, Xc[:, 2], 1e-9)
    u = cam["fx"] * Xc[:, 0] / z + cam["cx"] - half_pixel
    v = cam["fy"] * Xc[:, 1] / z + cam["cy"] - half_pixel
    r2 = (u - xy[:, 0]) ** 2 + (v - xy[:, 1]) ** 2
    stereo = ur >= 0
    r2 = r2 + np.where(stereo, (u - bf / z - ur) ** 2, 0.0)
    return np.sqrt(r2)


def ba_gaps(cam: dict, bf: float, R_cw: np.ndarray, t_cw: np.ndarray, kf: np.ndarray, xy: np.ndarray,
            ur: np.ndarray, level: np.ndarray, lm: np.ndarray, X0: np.ndarray, scale: float,
            iters: int = 8) -> np.ndarray:
    """How far each landmark lies from the bundle-adjustment optimum of its
    observations with the keyframe poses held: [L] |X* - X0| over the
    landmark's mean depth, X* by Gauss-Newton from X0 with each
    observation's level weight 1 / scale^(2 level) and the Huber kernel
    at the chi-squared gates (5.991 mono, 7.815 stereo). Observations: the
    keyframe index ``kf`` [O] into (R_cw [K,3,3], t_cw [K,3]), its left
    (u, v) ``xy`` [O,2], right u ``ur`` [O] (< 0: none), ``level`` [O] and
    landmark row ``lm`` [O] into X0 [L,3]. NaN for a landmark seen from
    fewer than two keyframes or whose normal matrix is near singular."""
    fx, fy, cx, cy = (float(cam[k]) for k in ("fx", "fy", "cx", "cy"))
    L = len(X0)
    R, t = R_cw[kf], t_cw[kf]
    stereo = ur >= 0
    w_lvl = scale ** (-2.0 * level.astype(np.float64))
    gate = np.where(stereo, 7.815, 5.991)
    X = X0.astype(np.float64).copy()
    for _ in range(iters):
        Xc = np.einsum("oij,oj->oi", R, X[lm]) + t
        z = np.where(np.abs(Xc[:, 2]) > 1e-9, Xc[:, 2], 1e-9)
        u = fx * Xc[:, 0] / z + cx
        r = np.stack([xy[:, 0] - u, xy[:, 1] - (fy * Xc[:, 1] / z + cy),
                      np.where(stereo, ur - (u - bf / z), 0.0)], axis=-1)
        Jc = np.zeros((len(lm), 3, 3))
        Jc[:, 0, 0], Jc[:, 0, 2] = fx / z, -fx * Xc[:, 0] / z ** 2
        Jc[:, 1, 1], Jc[:, 1, 2] = fy / z, -fy * Xc[:, 1] / z ** 2
        Jc[:, 2, 0], Jc[:, 2, 2] = fx / z, -(fx * Xc[:, 0] - bf) / z ** 2
        Jc[:, 2] *= stereo[:, None]
        J = Jc @ R
        chi2 = w_lvl * np.sum(r * r, axis=-1)
        w = w_lvl * np.where(chi2 <= gate, 1.0, np.sqrt(gate / np.maximum(chi2, 1e-12)))
        H = np.zeros((L, 3, 3))
        g = np.zeros((L, 3))
        np.add.at(H, lm, w[:, None, None] * np.einsum("oki,okj->oij", J, J))
        np.add.at(g, lm, w[:, None] * np.einsum("oki,ok->oi", J, r))
        ok = np.linalg.cond(H) < 1e10
        step = np.zeros((L, 3))
        step[ok] = np.linalg.solve(H[ok], g[ok][..., None])[..., 0]
        X = X + step
    n_kf = np.bincount(lm, minlength=L)
    depth = np.bincount(lm, weights=(np.einsum("oij,oj->oi", R, X0[lm]) + t)[:, 2], minlength=L)
    depth = depth / np.maximum(n_kf, 1)
    gap = np.linalg.norm(X - X0, axis=-1) / np.maximum(np.abs(depth), 1e-6)
    return np.where((n_kf >= 2) & ok, gap, np.nan)


def stereo_points(cam: dict, bf: float, R_cw: np.ndarray, t_cw: np.ndarray, xy: np.ndarray,
                  ur: np.ndarray) -> np.ndarray:
    """World points [M,3] of stereo observations (left xy [M,2], right u
    [M]) from cameras (R_cw [M,3,3], t_cw [M,3]): depth bf / disparity,
    no refinement (the control's map: bundle adjustment left out)."""
    z = bf / np.maximum(xy[:, 0] - ur, 1e-6)
    Xc = np.stack([(xy[:, 0] - cam["cx"]) / cam["fx"] * z, (xy[:, 1] - cam["cy"]) / cam["fy"] * z, z], axis=-1)
    return np.einsum("mji,mj->mi", R_cw, Xc - t_cw)


def reference_points(cam: dict, R_wc: np.ndarray, t_wc: np.ndarray, xy: np.ndarray, z: np.ndarray) -> np.ndarray:
    """World points [M,3] seen at level-0 coordinates xy with depths z
    from cameras (R_wc, t_wc) [M,3,3] / [M,3], in the renderer's
    pixel-centre convention."""
    ray = np.stack([(xy[:, 0] + 0.5 - cam["cx"]) / cam["fx"], (xy[:, 1] + 0.5 - cam["cy"]) / cam["fy"],
                    np.ones(len(xy))], axis=-1) * z[:, None]
    return np.einsum("mij,mj->mi", R_wc, ray) + t_wc


# --- IMU preintegration ----------------------------------------------------
def preintegrate(acc: np.ndarray, gyro: np.ndarray, dt: np.ndarray, bg: np.ndarray, ba: np.ndarray,
                 dtype=torch.float64):
    """(ΔR, ΔV, ΔP) of samples [S,3] with intervals dt [S] at bias (bg,
    ba): per sample ΔP += ΔV·dt + ½·ΔR·a·dt², ΔV += ΔR·a·dt,
    ΔR ← ΔR·Exp(ω·dt), with a = acc − ba, ω = gyro − bg. Every operation
    is carried out in ``dtype``."""
    to = lambda x: torch.as_tensor(np.asarray(x, np.float64)).to(dtype)
    A, G, D, bgt, bat = to(acc), to(gyro), to(dt), to(bg), to(ba)
    dR = torch.eye(3, dtype=dtype)
    dV = torch.zeros(3, dtype=dtype)
    dP = torch.zeros(3, dtype=dtype)
    for a_m, g_m, d in zip(A - bat, G - bgt, D):
        dRa = dR @ a_m
        dP = dP + dV * d + 0.5 * dRa * d * d
        dV = dV + dRa * d
        dR = dR @ synthetic.so3_exp((g_m * d).to(torch.float64)).to(dtype)
    return (dR.to(torch.float64).numpy(), dV.to(torch.float64).numpy(), dP.to(torch.float64).numpy())


def preint_rel_err(prog, ref) -> float:
    """Worst relative error of one window's ΔV and ΔP (norm of the gap over
    the reference's norm). ΔR is not compared: the program composes the
    window from per-frame segments, each integrated at the gyro bias
    estimate of its moment; over a window that estimate moves ΔR by about a
    tenth of its own rotation, while ΔV and ΔP, dominated by gravity, move
    by ~1e-4."""
    (_, Vp, Pp), (_, Vr, Pr) = prog, ref
    e_v = float(np.linalg.norm(Vp - Vr) / max(np.linalg.norm(Vr), 1e-9))
    e_p = float(np.linalg.norm(Pp - Pr) / max(np.linalg.norm(Pr), 1e-9))
    return max(e_v, e_p)


def verdict(readings: Dict[str, Optional[float]], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}) for the readings the cell
    compares. A reading that could not be made (None) fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        val = readings.get(name)
        out[name] = {"value": val, "limit": limit}
        if val is None or not np.isfinite(val) or val > limit:
            ok = False
    return ok, out
