"""Levenberg-Marquardt bundle adjustment: motion-only and Schur-complement.

Port of ``pose_optimization``, ``BAResult``, ``_eval_weights``,
``_build_normal_blocks``, ``bundle_adjust``, ``_schur_matvec``, ``_pcg``
and ``bundle_adjust_cg`` from
``orb_slam3_detailed_comments_kor_tpu/optim/ba.py`` (the paths with no
pose prior and no camera rig).

``pose_optimization`` (``Optimizer::PoseOptimization`` analog) runs LM on
one pose against fixed 3-D points, ``rounds`` x ``iters`` iterations with
chi2 inlier re-gating between rounds and the Huber kernel dropped after
round 2. ``bundle_adjust`` (local BA) runs LM jointly on poses and points,
eliminating the 3x3 landmark blocks with a dense Schur complement.
``bundle_adjust_cg`` (global BA) solves the same reduced system
matrix-free, by block-Jacobi PCG.
Accept/reject is branchless (``torch.where``) and the solves are
``inv_ex``/``solve_ex`` without error checks, so neither loop waits on the
device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_detailed_comments_kor_tpu_torch.optim import factors
from orb_slam3_detailed_comments_kor_tpu_torch.optim.factors import (
    CHI2_MONO,
    CHI2_STEREO,
    Observations,
)
from orb_slam3_detailed_comments_kor_tpu_torch.utils import lie


def _robust_cost(chi2, delta2):
    """Huber rho on squared error (for accept/reject decisions)."""
    return torch.where(
        chi2 <= delta2, chi2,
        2.0 * torch.sqrt(delta2 * torch.clamp(chi2, min=0.0)) - delta2,
    )


def _eval_weights(r, obs, use_huber):
    """Whitened chi2 + total IRLS weight per observation."""
    chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
    delta2 = torch.where(obs.u_right >= 0, CHI2_STEREO, CHI2_MONO)
    w_huber = factors.huber_weight(chi2, delta2) if use_huber else torch.ones_like(chi2)
    return chi2, w_huber, delta2


class PoseOptResult(NamedTuple):
    R_cw: torch.Tensor
    t_cw: torch.Tensor
    inlier: torch.Tensor     # [O] bool final inlier set
    n_inliers: torch.Tensor  # scalar


def pose_optimization(
    R_cw: torch.Tensor,
    t_cw: torch.Tensor,
    X: torch.Tensor,
    uv: torch.Tensor,
    u_right: torch.Tensor,
    inv_sigma2: torch.Tensor,
    valid: torch.Tensor,
    cam_params: torch.Tensor,
    bf: float,
    rounds: int = 4,
    iters: int = 10,
    prior=None,
    cam_model: str = "pinhole",
) -> PoseOptResult:
    """Optimize one pose against fixed points X [N,3], one observation each
    (uv/u_right/inv_sigma2/valid [N])."""
    if prior is not None:
        raise NotImplementedError("pose priors are not ported")
    n = X.shape[0]
    dev = X.device
    obs = Observations(
        kf=torch.zeros((n,), dtype=torch.int64, device=dev),
        lm=torch.arange(n, device=dev),
        uv=uv,
        u_right=u_right,
        inv_sigma2=inv_sigma2,
        valid=valid,
    )
    delta2 = torch.where(u_right >= 0, CHI2_STEREO, CHI2_MONO)
    eye6 = torch.eye(6, dtype=X.dtype, device=dev)

    def residual(R, t, active):
        return factors.reproj_residuals(
            R[None], t[None], X, obs._replace(valid=active), cam_params, bf,
            cam_model,
        )

    def chi2_of(r):
        return torch.sum(r * r, dim=-1) * inv_sigma2

    def cost_of(chi2, mask, use_huber):
        c = _robust_cost(chi2, delta2) if use_huber else chi2
        return torch.sum(c * mask)

    R, t, inlier = R_cw, t_cw, valid
    for round_idx in range(rounds):
        use_huber = round_idx < 2
        r0, _, dok0 = residual(R, t, inlier & valid)
        best_cost = cost_of(chi2_of(r0), inlier & valid & dok0, use_huber)
        lam = torch.full((), 1e-3, dtype=X.dtype, device=dev)  # no host copy
        for _ in range(iters):
            active = inlier & valid
            r, row_mask, depth_ok = residual(R, t, active)
            active = active & depth_ok
            chi2 = chi2_of(r)
            w_h = factors.huber_weight(chi2, delta2) if use_huber else 1.0
            w = inv_sigma2 * w_h * active
            Jp, _ = factors.reproj_jacobians(
                R[None], t[None], X, obs, cam_params, bf, cam_model
            )
            Jp = Jp * row_mask[:, :, None]
            # H = Σ w·JᵀJ and b = -Σ w·Jᵀr as two [6, 3·O] matmuls
            Jw = (Jp * w[:, None, None]).reshape(-1, 6).T
            H = Jw @ Jp.reshape(-1, 6)
            b = -(Jw @ r.reshape(-1))
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye6
            delta = torch.linalg.solve_ex(Hd, b)[0]
            dR, dt = lie.se3_exp(delta)
            R_new = dR @ R
            t_new = dR @ t + dt
            r2, _, dok2 = residual(R_new, t_new, active)
            cost_new = cost_of(chi2_of(r2), active & dok2, use_huber)
            accept = cost_new < best_cost
            R = torch.where(accept, R_new, R)
            t = torch.where(accept, t_new, t)
            lam = torch.where(accept, lam * 0.33, lam * 3.0)
            best_cost = torch.where(accept, cost_new, best_cost)
        # re-gate inliers on the FULL observation set (outliers can recover)
        r1, _, dok1 = residual(R, t, valid)
        inlier = (chi2_of(r1) <= delta2) & valid & dok1
    R = lie.project_to_so3(R)
    return PoseOptResult(R, t, inlier, torch.sum(inlier))


# ---------------------------------------------------------------------------
# Full BA with Schur elimination (LocalBundleAdjustment analog)
# ---------------------------------------------------------------------------

class BAResult(NamedTuple):
    R_cw: torch.Tensor
    t_cw: torch.Tensor
    X: torch.Tensor
    chi2: torch.Tensor     # final per-obs chi2
    inlier: torch.Tensor   # [O] chi2-gate at the end


def _build_normal_blocks(R_cw, t_cw, X, obs, cam_params, bf, w_total, row_mask,
                         cam_model="pinhole", rig=None):
    """Per-obs Jacobian blocks + scatter-accumulated Hpp/Hll/b.

    Returns (Hpp [K,6,6], Hll [L,3,3], bp [K,6], bl [L,3], Wpl [K,6,L,3]).
    The scatters are ``index_add_``: on the card their float adds land in
    no fixed order, so the sums agree with the reference to rounding.
    """
    if rig is not None:
        raise NotImplementedError("camera rigs are not ported")
    K = R_cw.shape[0]
    L = X.shape[0]
    Jp, Jl = factors.reproj_jacobians(R_cw, t_cw, X, obs, cam_params, bf, cam_model)
    Jp = Jp * row_mask[:, :, None]
    Jl = Jl * row_mask[:, :, None]
    r, _, _ = factors.reproj_residuals(R_cw, t_cw, X, obs, cam_params, bf, cam_model)
    JpT, JlT = Jp.transpose(1, 2), Jl.transpose(1, 2)
    w3 = w_total[:, None, None]
    zeros = lambda *shape: torch.zeros(shape, dtype=X.dtype, device=X.device)
    Hpp = zeros(K, 6, 6).index_add_(0, obs.kf, w3 * (JpT @ Jp))
    Hll = zeros(L, 3, 3).index_add_(0, obs.lm, w3 * (JlT @ Jl))
    bp = zeros(K, 6).index_add_(0, obs.kf, -w_total[:, None] * (JpT @ r[..., None])[..., 0])
    bl = zeros(L, 3).index_add_(0, obs.lm, -w_total[:, None] * (JlT @ r[..., None])[..., 0])
    # W[k, :, l, :] += w JpᵀJl, scattered over the flat (k, l) pairs
    Wpl = zeros(K * L, 6, 3).index_add_(0, obs.kf * L + obs.lm, w3 * (JpT @ Jl))
    return Hpp, Hll, bp, bl, Wpl.view(K, L, 6, 3).permute(0, 2, 1, 3)


def bundle_adjust(
    R_cw: torch.Tensor,
    t_cw: torch.Tensor,
    X: torch.Tensor,
    obs: Observations,
    fixed_pose: torch.Tensor,
    fixed_point: torch.Tensor,
    cam_params: torch.Tensor,
    bf: float,
    iters: int = 10,
    use_huber: bool = True,
    cam_model: str = "pinhole",
    rig=None,
) -> BAResult:
    """Joint pose+structure LM with Schur-complement landmark elimination.

    R_cw [K,3,3], t_cw [K,3], X [L,3]; obs is the flat edge table;
    fixed_pose [K] / fixed_point [L] bool masks freeze variables (the
    reference's fixed-anchor and fixed-observer keyframes). The reduced
    camera system is dense ([6K, 6K]) and solved by LU with Jacobi
    scaling, as the reference does.
    """
    if rig is not None:
        raise NotImplementedError("camera rigs are not ported")
    K = R_cw.shape[0]
    L = X.shape[0]
    dev, dt_ = X.device, X.dtype
    delta2 = torch.where(obs.u_right >= 0, CHI2_STEREO, CHI2_MONO)
    eye3 = torch.eye(3, dtype=dt_, device=dev)
    eye6 = torch.eye(6, dtype=dt_, device=dev)
    kk = torch.arange(K, device=dev)
    free_p = (~fixed_pose).to(dt_)
    free_l = (~fixed_point).to(dt_)
    fp = fixed_pose[:, None].expand(K, 6).reshape(-1)

    def total_cost(R, t, Xc):
        r, _, dok = factors.reproj_residuals(R, t, Xc, obs, cam_params, bf, cam_model)
        chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
        c = _robust_cost(chi2, delta2) if use_huber else chi2
        return torch.sum(c * (obs.valid & dok)), chi2

    R, t, Xc = R_cw, t_cw, X
    lam = torch.full((), 1e-4, dtype=dt_, device=dev)  # no host copy
    best_cost, _ = total_cost(R, t, Xc)
    for _ in range(iters):
        r, row_mask, depth_ok = factors.reproj_residuals(R, t, Xc, obs, cam_params, bf, cam_model)
        _, w_h, _ = _eval_weights(r, obs, use_huber)
        w = obs.inv_sigma2 * w_h * (obs.valid & depth_ok)
        # freeze contributions of fixed variables by zeroing their Jacobians
        Hpp, Hll, bp, bl, Wpl = _build_normal_blocks(
            R, t, Xc, obs._replace(valid=obs.valid & depth_ok),
            cam_params, bf, w, row_mask, cam_model,
        )
        bp = bp * free_p[:, None]
        bl = bl * free_l[:, None]
        Wpl = Wpl * free_p[:, None, None, None] * free_l[None, None, :, None]

        tr3 = torch.diagonal(Hll, dim1=-2, dim2=-1).sum(-1)
        Hll_d = Hll + lam * eye3[None] * (tr3[:, None, None] / 3.0 + 1e-3)
        # fixed landmarks -> identity block (delta forced to 0 via bl=0)
        Hll_d = torch.where(fixed_point[:, None, None], eye3[None], Hll_d)
        Hll_inv = torch.linalg.inv_ex(Hll_d)[0]

        # S = Hpp_diag - W Hll⁻¹ Wᵀ (dense over pose pairs), as [6K, 3L] products
        W2 = Wpl.reshape(K * 6, L * 3)
        Y2 = (W2.view(K * 6, L, 1, 3) @ Hll_inv).reshape(K * 6, L * 3)
        S = -(Y2 @ W2.T)
        diag_damp = lam * torch.diag_embed(torch.diagonal(Hpp, dim1=-2, dim2=-1)) + 1e-6 * eye6
        S = S.view(K, 6, K, 6)
        S[kk, :, kk, :] += Hpp + diag_damp
        b_s = bp - (Y2 @ bl.reshape(-1)).view(K, 6)

        # fixed poses -> identity rows/cols
        Sf = torch.where(fp[:, None] | fp[None, :], 0.0, S.view(K * 6, K * 6))
        Sf = Sf + torch.diag(fp.to(dt_))
        b_flat = torch.where(fp, 0.0, b_s.reshape(-1))

        # LU with Jacobi scaling, NOT Cholesky: a marginally-non-PD f32
        # system makes Cholesky emit NaN, and NaN-poisoned landmarks mask
        # themselves out of the cost via the depth gate -> silently accepted
        d = torch.sqrt(torch.clamp(torch.diagonal(Sf), min=1e-10))
        dp = (torch.linalg.solve_ex(Sf / d[:, None] / d[None, :], b_flat / d)[0] / d).view(K, 6)
        rhs = bl - (W2.T @ dp.reshape(-1)).view(L, 3)
        dl = (Hll_inv @ rhs[..., None])[..., 0] * free_l[:, None]

        dR, dt = lie.se3_exp(dp)
        R_new = dR @ R
        t_new = (dR @ t[..., None])[..., 0] + dt
        X_new = Xc + dl
        cost_new, _ = total_cost(R_new, t_new, X_new)
        accept = (
            (cost_new < best_cost)
            & torch.isfinite(dp).all() & torch.isfinite(dl).all()
        )
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        Xc = torch.where(accept, X_new, Xc)
        lam = torch.where(accept, lam * 0.33, lam * 4.0)
        best_cost = torch.where(accept, cost_new, best_cost)
    R = lie.project_to_so3(R)
    _, chi2 = total_cost(R, t, Xc)
    inlier = (chi2 <= delta2) & obs.valid
    return BAResult(R, t, Xc, chi2, inlier)


# ---------------------------------------------------------------------------
# Matrix-free Schur BA: PCG on the reduced camera system (global BA)
# ---------------------------------------------------------------------------

class _Segments(NamedTuple):
    """A sorted segment layout of one index vector, made once per solve:
    ``perm`` sorts the rows by index (stable), ``same[k]`` marks the
    sorted rows whose row 2^k before lies in the same segment, ``ends``
    is each segment's last sorted row and ``nonempty`` whether it has
    one."""
    perm: torch.Tensor
    same: tuple
    ends: torch.Tensor
    nonempty: torch.Tensor


def _segments(idx: torch.Tensor, n: int) -> _Segments:
    O = idx.shape[0]
    sidx, perm = torch.sort(idx, stable=True)
    counts = torch.zeros((n,), dtype=torch.int64, device=idx.device).index_add_(
        0, idx, torch.ones_like(idx))
    same, d = [], 1
    while d < O:
        same.append(torch.cat([torch.zeros((d,), dtype=torch.bool, device=idx.device),
                               sidx[d:] == sidx[:-d]]))
        d *= 2
    ends = torch.clamp(torch.cumsum(counts, 0) - 1, min=0)
    return _Segments(perm, tuple(same), ends, counts > 0)


def _segment_sum(vals: torch.Tensor, seg: _Segments) -> torch.Tensor:
    """Σ of the rows of ``vals`` per segment, [n, ...], by a segmented
    Hillis-Steele scan over the sorted rows: the same adds in the same
    order on every run and device, and no host read. (``index_add_``'s
    atomics moved one GBA slice's poses by up to 1.8e-4 m and its cost by
    5e-4 relative between two runs on the same inputs on an H100, about
    the GBA budget's 1e-3 convergence test; ``index_put_(accumulate=True)``
    is deterministic but took 685 ms of device time a slice and read the
    host.)"""
    v = vals[seg.perm]
    d = 1
    for same in seg.same:
        shifted = torch.cat([torch.zeros_like(v[:d]), v[:-d]])
        v = v + torch.where(same.reshape((-1,) + (1,) * (v.dim() - 1)), shifted, 0.0)
        d *= 2
    out = v[seg.ends]
    return torch.where(seg.nonempty.reshape((-1,) + (1,) * (v.dim() - 1)), out, 0.0)


def _schur_matvec(v, A, Hll_inv, kf, lm, Hpp_d, fixed_pose, seg_kf, seg_lm):
    """S·v for v [K,6] without forming S = Hpp − W Hll⁻¹ Wᵀ.

    A [O,6,3] = w·Jpᵀ·Jl per observation (fixed rows/cols already zeroed),
    Hll_inv [L,3,3], Hpp_d [K,6,6] damped pose blocks; ``seg_kf`` and
    ``seg_lm`` the observations' segments by keyframe and landmark."""
    # u = Wᵀ v per landmark, then y = Hll⁻¹ u, then W y per pose
    u = _segment_sum((A.transpose(1, 2) @ v[kf][..., None])[..., 0], seg_lm)
    y = (Hll_inv @ u[..., None])[..., 0]
    Wy = _segment_sum((A @ y[lm][..., None])[..., 0], seg_kf)
    Sv = (Hpp_d @ v[..., None])[..., 0] - Wy
    return torch.where(fixed_pose[:, None], v, Sv)


def _pcg(matvec, b, Minv_blocks, iters):
    """Block-Jacobi PCG for S·x = b with x, b [K,6]; the step guards stay
    on the device."""
    def apply_M(r):
        return (Minv_blocks @ r[..., None])[..., 0]

    x = torch.zeros_like(b)
    r = b
    z = apply_M(r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(iters):
        Sp = matvec(p)
        pSp = torch.sum(p * Sp)
        ok = torch.abs(pSp) > 1e-20
        alpha = torch.where(ok, rz / torch.where(ok, pSp, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * Sp
        z = apply_M(r)
        rz_new = torch.sum(r * z)
        ok = torch.abs(rz) > 1e-20
        beta = torch.where(ok, rz_new / torch.where(ok, rz, 1.0), 0.0)
        p = z + beta * p
        rz = rz_new
    return x


def bundle_adjust_cg(
    R_cw: torch.Tensor,
    t_cw: torch.Tensor,
    X: torch.Tensor,
    obs: Observations,
    fixed_pose: torch.Tensor,
    fixed_point: torch.Tensor,
    cam_params: torch.Tensor,
    bf: float,
    iters: int = 10,
    cg_iters: int = 24,
    use_huber: bool = True,
    cam_model: str = "pinhole",
    rig=None,
) -> BAResult:
    """Large-scale BA: LM with block-Jacobi PCG on the implicit reduced
    camera system (``Optimizer::GlobalBundleAdjustemnt`` at map scale).

    Same contract as :func:`bundle_adjust`; memory is O(obs + K·36 + L·9)
    instead of O(K·L·18). The per-observation blocks are summed per
    keyframe and per landmark with ``_segment_sum`` (deterministic).
    """
    if rig is not None:
        raise NotImplementedError("camera rigs are not ported")
    K = R_cw.shape[0]
    L = X.shape[0]
    dev, dt_ = X.device, X.dtype
    delta2 = torch.where(obs.u_right >= 0, CHI2_STEREO, CHI2_MONO)
    free_p = (~fixed_pose).to(dt_)
    free_l = (~fixed_point).to(dt_)
    eye3 = torch.eye(3, dtype=dt_, device=dev)
    eye6 = torch.eye(6, dtype=dt_, device=dev)
    kf, lm = obs.kf.to(torch.int64), obs.lm.to(torch.int64)
    seg_kf, seg_lm = _segments(kf, K), _segments(lm, L)

    def total_cost(R, t, Xc):
        r, _, dok = factors.reproj_residuals(R, t, Xc, obs, cam_params, bf, cam_model)
        chi2 = torch.sum(r * r, dim=-1) * obs.inv_sigma2
        c = _robust_cost(chi2, delta2) if use_huber else chi2
        return torch.sum(c * (obs.valid & dok)), chi2

    R, t, Xc = R_cw, t_cw, X
    lam = torch.full((), 1e-4, dtype=dt_, device=dev)  # no host copy
    best_cost, _ = total_cost(R, t, Xc)
    for _ in range(iters):
        r, row_mask, depth_ok = factors.reproj_residuals(R, t, Xc, obs, cam_params, bf, cam_model)
        _, w_h, _ = _eval_weights(r, obs, use_huber)
        w = obs.inv_sigma2 * w_h * (obs.valid & depth_ok)
        Jp, Jl = factors.reproj_jacobians(R, t, Xc, obs, cam_params, bf, cam_model)
        Jp = Jp * row_mask[:, :, None]
        Jl = Jl * row_mask[:, :, None]
        JpT, JlT = Jp.transpose(1, 2), Jl.transpose(1, 2)
        w3 = w[:, None, None]
        Hpp = _segment_sum(w3 * (JpT @ Jp), seg_kf)
        Hll = _segment_sum(w3 * (JlT @ Jl), seg_lm)
        bp = _segment_sum(-w[:, None] * (JpT @ r[..., None])[..., 0], seg_kf) * free_p[:, None]
        bl = _segment_sum(-w[:, None] * (JlT @ r[..., None])[..., 0], seg_lm) * free_l[:, None]
        A = (w * free_p[kf] * free_l[lm])[:, None, None] * (JpT @ Jl)  # [O,6,3]

        tr3 = torch.diagonal(Hll, dim1=-2, dim2=-1).sum(-1)
        Hll_d = Hll + lam * eye3[None] * (tr3[:, None, None] / 3.0 + 1e-3)
        Hll_d = torch.where(fixed_point[:, None, None], eye3[None], Hll_d)
        Hll_inv = torch.linalg.inv_ex(Hll_d)[0]
        Hpp_d = Hpp + lam * torch.diag_embed(torch.diagonal(Hpp, dim1=-2, dim2=-1)) + 1e-6 * eye6[None]
        Hpp_d = torch.where(fixed_pose[:, None, None], eye6[None], Hpp_d)

        # RHS: b_s = bp − W Hll⁻¹ bl
        y0 = (Hll_inv @ bl[..., None])[..., 0]
        Wy0 = _segment_sum((A @ y0[lm][..., None])[..., 0], seg_kf)
        b_s = torch.where(fixed_pose[:, None], 0.0, bp - Wy0)
        # block-Jacobi preconditioner: S's diagonal blocks ≈ Hpp_d
        Minv = torch.linalg.inv_ex(Hpp_d)[0]
        dp = _pcg(lambda v: _schur_matvec(v, A, Hll_inv, kf, lm, Hpp_d, fixed_pose, seg_kf, seg_lm),
                  b_s, Minv, cg_iters)
        dp = dp * free_p[:, None]
        # back-substitute landmarks
        u = _segment_sum((A.transpose(1, 2) @ dp[kf][..., None])[..., 0], seg_lm)
        dl = (Hll_inv @ (bl - u)[..., None])[..., 0] * free_l[:, None]

        dR, dt = lie.se3_exp(dp)
        R_new = dR @ R
        t_new = (dR @ t[..., None])[..., 0] + dt
        X_new = Xc + dl
        cost_new, _ = total_cost(R_new, t_new, X_new)
        accept = (
            (cost_new < best_cost)
            & torch.isfinite(dp).all() & torch.isfinite(dl).all()
        )
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        Xc = torch.where(accept, X_new, Xc)
        lam = torch.where(accept, lam * 0.33, lam * 4.0)
        best_cost = torch.where(accept, cost_new, best_cost)
    R = lie.project_to_so3(R)
    _, chi2 = total_cost(R, t, Xc)
    inlier = (chi2 <= delta2) & obs.valid
    return BAResult(R, t, Xc, chi2, inlier)
