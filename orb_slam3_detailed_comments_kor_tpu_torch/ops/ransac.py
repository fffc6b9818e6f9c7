"""Batched closed-form alignment + fixed-budget RANSAC.

Port of ``horn_align``, ``RansacResult``, ``sim3_ransac``,
``sim3_ransac_reproj``, ``mlpnp_refine`` and ``pnp_ransac`` from
``orb_slam3_detailed_comments_kor_tpu/ops/ransac.py`` (the counterparts of
``Sim3Solver`` and the MLPnP relocalization solver): a fixed budget of
hypotheses is evaluated in one batch and the one with the most inliers
wins (the first on ties, as ``jnp.argmax``).

Samples are drawn by ``utils.prng.choice`` from the caller's key, the
reference's own threefry stream, so both packages evaluate the same
hypotheses; every RANSAC function also takes the drawn indices directly
(``idx``). The 3x3 SVD of Horn's method is a Jacobi eigen-solve in float64
(``_horn_rotation``) and the small solves are ``solve_ex``/``inv_ex``:
nothing here waits on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_detailed_comments_kor_tpu_torch.models import camera as cam_mod
from orb_slam3_detailed_comments_kor_tpu_torch.utils import lie, prng

_JACOBI_SWEEPS = 8


def _jacobi_eigh3(B):
    """Eigen-decomposition of symmetric [...,3,3] matrices by cyclic
    Jacobi rotations (fixed sweeps, no host read): (eigenvalues [...,3],
    eigenvectors [...,3,3] as columns), unsorted."""
    V = torch.eye(3, dtype=B.dtype, device=B.device).expand(B.shape).clone()
    eye = V.clone()
    for _ in range(_JACOBI_SWEEPS):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            apq = B[..., p, q]
            app = B[..., p, p]
            aqq = B[..., q, q]
            zero = torch.abs(apq) < 1e-300
            theta = (aqq - app) / (2.0 * torch.where(zero, 1.0, apq))
            sgn = torch.where(theta >= 0, 1.0, -1.0)
            t = torch.where(zero, 0.0, sgn / (torch.abs(theta) + torch.sqrt(theta * theta + 1.0)))
            c = 1.0 / torch.sqrt(t * t + 1.0)
            s = t * c
            J = eye.clone()
            J[..., p, p] = c
            J[..., q, q] = c
            J[..., p, q] = s
            J[..., q, p] = -s
            B = J.transpose(-1, -2) @ B @ J
            V = V @ J
    return torch.diagonal(B, dim1=-2, dim2=-1), V


def _unit(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-300)


def _horn_rotation(C):
    """R = U·diag(1, 1, sign det(U Vᵀ))·Vᵀ from the SVD C = U D Vᵀ of
    [...,3,3] matrices, and Σ D·diag(S) (the scale numerator).

    With v1, v2 the two leading right singular vectors (Jacobi on CᵀC in
    float64) and u_i = C v_i / σ_i, R = u1 v1ᵀ + u2 v2ᵀ + (u1×u2)(v1×v2)ᵀ:
    independent of the singular vectors' signs, with det R = +1. A C of
    rank below 2 has no unique answer (the reference's is whatever its
    LAPACK returns); here u2 completes u1 by a cross product, and C = 0
    gives the identity, as LAPACK's SVD of zero does.
    """
    Cd = C.to(torch.float64)
    lam, V = _jacobi_eigh3(Cd.transpose(-1, -2) @ Cd)
    order = torch.argsort(lam, dim=-1, descending=True)
    lam = torch.gather(lam, -1, order)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    sig = torch.sqrt(torch.clamp(lam, min=0.0))
    v1, v2 = V[..., :, 0], V[..., :, 1]
    Cv1 = (Cd @ v1[..., None])[..., 0]
    Cv2 = (Cd @ v2[..., None])[..., 0]
    u1 = _unit(Cv1)
    u2 = Cv2 - torch.sum(u1 * Cv2, -1, keepdim=True) * u1
    # rank < 2: any unit vector orthogonal to u1
    eye = torch.eye(3, dtype=Cd.dtype, device=Cd.device)  # made on the device: no host copy
    axis = torch.where(torch.abs(u1[..., :1]) < 0.9, eye[0], eye[1])
    rank2 = sig[..., 1] > 1e-12 * torch.clamp(sig[..., 0], min=1e-300)
    u2 = _unit(torch.where(rank2[..., None], u2, torch.linalg.cross(u1, axis)))
    u3 = torch.linalg.cross(u1, u2)
    v3 = torch.linalg.cross(v1, v2)
    R = u1[..., :, None] * v1[..., None, :] + u2[..., :, None] * v2[..., None, :] \
        + u3[..., :, None] * v3[..., None, :]
    R = torch.where((sig[..., 0] > 0)[..., None, None], R, eye)
    det = torch.sum(Cd[..., :, 0] * torch.linalg.cross(Cd[..., :, 1], Cd[..., :, 2]), dim=-1)
    d = torch.where(det < 0, -1.0, 1.0)
    return R.to(C.dtype), (sig[..., 0] + sig[..., 1] + d * sig[..., 2]).to(C.dtype)


def horn_align(src, dst, weights, fix_scale: bool = True):
    """Weighted closed-form similarity: dst ≈ s·R·src + t (Horn/Umeyama).

    src/dst [M,3], weights [..., M] (a 0/1 mask or soft; leading dims
    batch hypotheses). Returns (R [...,3,3], t [...,3], s [...])."""
    w = weights
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)
    mu_s = torch.sum(src * w[..., None], dim=-2) / wsum[..., None]
    mu_d = torch.sum(dst * w[..., None], dim=-2) / wsum[..., None]
    xs = src - mu_s[..., None, :]
    xd = dst - mu_d[..., None, :]
    C = (xd * w[..., None]).transpose(-1, -2) @ xs / wsum[..., None, None]
    R, dsum = _horn_rotation(C)
    if fix_scale:
        s = torch.ones_like(wsum)
    else:
        var_s = torch.sum(xs * xs * w[..., None], dim=(-2, -1)) / wsum
        s = dsum / torch.clamp(var_s, min=1e-9)
    t = mu_d - s[..., None] * (R @ mu_s[..., None])[..., 0]
    return R, t, s


class RansacResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor
    inliers: torch.Tensor   # [M] bool
    n_inliers: torch.Tensor


def _first_max(counts):
    """The winning hypothesis as a 1-element index tensor: the first
    maximum (``jnp.argmax``). Indexing with a 0-d tensor would read it back
    to the host; a 1-element tensor stays on the device."""
    return torch.argmax(counts).reshape(1)


def _draw(key, valid, shape):
    """The reference's sample draw: ``choice`` over the valid entries,
    uniform among them."""
    probs = valid.to(torch.float32)
    probs = probs / torch.clamp(probs.sum(), min=1e-9)
    return prng.choice(key, valid.shape[0], shape, probs)


def _sample_weights(idx, valid):
    """[H, M] 0/1 weights of each hypothesis' sample (a repeated index
    counts once), masked by ``valid``."""
    w = torch.zeros((idx.shape[0], valid.shape[0]), dtype=torch.float32, device=valid.device)
    w.scatter_(1, idx.to(torch.int64), 1.0)
    return w * valid


def _warp(R, t, s, X):
    """s·R·X + t for hypotheses [...] over points X [M,3] -> [...,M,3]."""
    return s[..., None, None] * (X @ R.transpose(-1, -2)) + t[..., None, :]


def sim3_ransac(src, dst, valid, key, n_hyp: int = 128, inlier_th: float = 0.10,
                fix_scale: bool = True, idx=None) -> RansacResult:
    """Fixed-budget 3-point RANSAC for dst ≈ s·R·src + t, Euclidean
    inlier gate, refit on the best hypothesis' inliers. ``idx`` [n_hyp, 3]
    replaces the draw from ``key``."""
    if idx is None:
        idx = _draw(key, valid, (n_hyp, 3))
    Rs, ts, ss = horn_align(src, dst, _sample_weights(idx, valid), fix_scale)
    err = torch.linalg.vector_norm(dst - _warp(Rs, ts, ss, src), dim=-1)
    inls = (err < inlier_th) & valid
    best = _first_max(torch.sum(inls, dim=-1))
    R, t, s = horn_align(src, dst, inls[best][0].to(torch.float32), fix_scale)
    err = torch.linalg.vector_norm(dst - _warp(R, t, s, src), dim=-1)
    inl = (err < inlier_th) & valid
    return RansacResult(R=R, t=t, s=s, inliers=inl, n_inliers=torch.sum(inl))


def _cam_project(cam_params, pc, cam_model):
    z = torch.clamp(pc[..., 2], min=1e-6)
    return cam_mod.project(cam_params, torch.cat([pc[..., :2], z[..., None]], dim=-1), cam_model)


def sim3_ransac_reproj(
    src, dst, uv_a, uv_b, sigma2_a, sigma2_b, pose_a, pose_b, cam_params, valid, key,
    n_hyp: int = 128, chi2_th: float = 9.21, fix_scale: bool = True, refine_iters: int = 8,
    cam_model: str = "pinhole", idx=None,
) -> RansacResult:
    """Sim3 RANSAC with reprojection inlier gating in both keyframes'
    cameras and a Gauss-Newton reprojection refine of the winner
    (``Sim3Solver::CheckInliers`` + ``Optimizer::OptimizeSim3``).

    src/dst [M,3] matched landmark positions (current / loop side); uv_a,
    uv_b [M,2] their pixels in keyframes a (current) and b (loop);
    sigma2_* per-feature σ²; pose_a/pose_b (R_cw, t_cw). The warp maps
    current-map coordinates to loop-side ones: dst ≈ s·R·src + t.
    Hypotheses are selected at a 4x looser gate; the identity hypothesis
    is always a candidate and wins ties. ``idx`` [n_hyp, 3] replaces the
    draw from ``key``.
    """
    Ra, ta = pose_a
    Rb, tb = pose_b
    M = src.shape[0]
    dt_ = src.dtype

    def project(R_cw, t_cw, P):
        pc = P @ R_cw.T + t_cw
        return _cam_project(cam_params, pc, cam_model), pc[..., 2] > 1e-3

    def reproj_inliers(R, t, s, th=chi2_th):
        pb, okb = project(Rb, tb, _warp(R, t, s, src))
        eb = torch.sum((pb - uv_b) ** 2, -1) / torch.clamp(sigma2_b, min=1e-6)
        si = 1.0 / torch.clamp(s, min=1e-9)
        Xa_hat = si[..., None, None] * ((dst - t[..., None, :]) @ R)
        pa, oka = project(Ra, ta, Xa_hat)
        ea = torch.sum((pa - uv_a) ** 2, -1) / torch.clamp(sigma2_a, min=1e-6)
        return (eb < th) & (ea < th) & oka & okb & valid

    chi2_sel = 4.0 * chi2_th
    if idx is None:
        idx = _draw(key, valid, (n_hyp, 3))
    Rs, ts, ss = horn_align(src, dst, _sample_weights(idx, valid), fix_scale)
    counts = torch.sum(reproj_inliers(Rs, ts, ss, chi2_sel), dim=-1)
    # the identity null hypothesis, first, so that ties break toward it
    R_id = torch.eye(3, dtype=dt_, device=src.device)
    t_id = torch.zeros((3,), dtype=dt_, device=src.device)
    s_id = torch.ones((), dtype=dt_, device=src.device)
    n_id = torch.sum(reproj_inliers(R_id, t_id, s_id, chi2_sel))
    Rs = torch.cat([R_id[None], Rs])
    ts = torch.cat([t_id[None], ts])
    ss = torch.cat([s_id[None], ss])
    best = _first_max(torch.cat([n_id[None], counts]))
    R, t, s = Rs[best][0], ts[best][0], ss[best][0]
    inl = reproj_inliers(R, t, s, chi2_sel)
    R, t, s = horn_align(src, dst, inl.to(dt_), fix_scale)
    data = dict(
        src=src, dst=dst, uv_a=uv_a, uv_b=uv_b, Ra=Ra, ta=ta, Rb=Rb, tb=tb, cam=cam_params,
        wb=torch.sqrt(inl / torch.clamp(sigma2_b, min=1e-6))[:, None],
        wa=torch.sqrt(inl / torch.clamp(sigma2_a, min=1e-6))[:, None],
    )

    def residuals(params, R0, t0, s0, d):
        phi, rho, lam = params[:3], params[3:6], params[6]
        dR = lie.so3_exp(phi)
        R_ = dR @ R0
        s_ = s0 * torch.exp(0.0 * lam if fix_scale else lam)
        t_ = dR @ t0 + rho
        pb = _cam_project(d["cam"], _warp(R_, t_, s_, d["src"]) @ d["Rb"].T + d["tb"], cam_model)
        si = 1.0 / torch.clamp(s_, min=1e-9)
        Xa_hat = si * ((d["dst"] - t_) @ R_)
        pa = _cam_project(d["cam"], Xa_hat @ d["Ra"].T + d["ta"], cam_model)
        return torch.cat([((pb - d["uv_b"]) * d["wb"]).reshape(-1),
                          ((pa - d["uv_a"]) * d["wa"]).reshape(-1)])

    R, t, s = _gauss_newton_sim3(residuals, data, R, t, s, refine_iters, fix_scale)
    R = lie.project_to_so3(R)
    inl = reproj_inliers(R, t, s)
    return RansacResult(R=R, t=t, s=s, inliers=inl, n_inliers=torch.sum(inl))


def jacfwd64(f, p0, *args):
    """``torch.func.jacfwd(f)(p0, *args)`` evaluated in float64 and
    returned in p0's dtype: forward-mode differentiation in torch gives a
    float32 expression divided by (or dividing) a Python float a float64
    tangent, which the next product of tensors rejects. Float tensors
    among ``args`` (nested in tuples, NamedTuples and dicts) go to
    float64 as well."""
    def up(a):
        if isinstance(a, dict):
            return {k: up(v) for k, v in a.items()}
        if isinstance(a, tuple) and hasattr(a, "_fields"):  # a NamedTuple
            return type(a)(*(up(v) for v in a))
        if isinstance(a, (tuple, list)):
            return type(a)(up(v) for v in a)
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            return a.to(torch.float64)
        return a
    return torch.func.jacfwd(f)(up(p0), *up(args)).to(p0.dtype)


def _gauss_newton_sim3(residuals, data, R, t, s, iters, fix_scale):
    """``iters`` Gauss-Newton steps on a 7-D (φ, ρ, λ) left update of
    (R, t, s); ``residuals(p, R, t, s, data)``. The Jacobian comes from
    forward-mode differentiation, as the reference's ``jax.jacfwd``."""
    p0 = torch.zeros((7,), dtype=t.dtype, device=t.device)
    eye7 = torch.eye(7, dtype=t.dtype, device=t.device)
    for _ in range(iters):
        r0 = residuals(p0, R, t, s, data)
        J = jacfwd64(residuals, p0, R, t, s, data)
        H = J.T @ J + 1e-6 * eye7
        dx = -torch.linalg.solve_ex(H, J.T @ r0)[0]
        dx = torch.where(torch.isfinite(dx), dx, 0.0)
        dR = lie.so3_exp(dx[:3])
        R, t = dR @ R, dR @ t + dx[3:6]
        s = s * torch.exp(0.0 * dx[6] if fix_scale else dx[6])
    return R, t, s


def mlpnp_refine(X, uv, w, cam_params, R0, t0, iters: int = 6, sigma_px: float = 1.0):
    """Maximum-likelihood PnP polish (the MLPnP formulation, ``src/
    MLPnPsolver.cpp``): residuals in the tangent space of each observed
    bearing, weighted by the bearing covariance propagated from pixel
    noise; Gauss-Newton on se(3). X [M,3], uv [M,2], w [M] inlier weights.
    Returns (R, t)."""
    fx, fy, cx, cy = cam_params[0], cam_params[1], cam_params[2], cam_params[3]
    dev, dt_ = X.device, X.dtype
    m = torch.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy, torch.ones_like(uv[:, 0])], dim=-1)
    norm_m = torch.linalg.vector_norm(m, dim=-1, keepdim=True)
    v = m / norm_m
    eye3 = torch.eye(3, dtype=dt_, device=dev)
    seed = torch.where((torch.abs(v[:, 0]) < 0.9)[:, None], eye3[0], eye3[1])
    r_b = torch.linalg.cross(v, seed)
    r_b = r_b / torch.linalg.vector_norm(r_b, dim=-1, keepdim=True)
    s_b = torch.linalg.cross(v, r_b)
    N = torch.stack([r_b, s_b], dim=-1)  # [M,3,2]
    P_v = eye3[None] - v[:, :, None] * v[:, None, :]
    J_px = P_v[:, :, :2] / torch.stack([fx * norm_m[:, 0], fy * norm_m[:, 0]], -1)[:, None, :]
    sigma_v = (sigma_px ** 2) * (J_px @ J_px.transpose(-1, -2))
    E = N.transpose(-1, -2) @ sigma_v @ N  # [M,2,2]
    Wm = torch.linalg.inv_ex(E + 1e-12 * torch.eye(2, dtype=dt_, device=dev)[None])[0]
    eye6 = torch.eye(6, dtype=dt_, device=dev)
    R, t = R0, t0
    for _ in range(iters):
        p = X @ R.T + t
        nrm = torch.linalg.vector_norm(p, dim=-1, keepdim=True)
        n = p / torch.clamp(nrm, min=1e-9)
        e = (N.transpose(-1, -2) @ n[..., None])[..., 0]  # [M,2]
        Pn = (eye3[None] - n[:, :, None] * n[:, None, :]) / torch.clamp(nrm[:, :, None], min=1e-9)
        dp = torch.cat([eye3.expand(X.shape[0], 3, 3), -lie.hat(p)], dim=-1)  # [M,3,6]
        J = N.transpose(-1, -2) @ Pn @ dp  # [M,2,6]
        JtW = J.transpose(-1, -2) @ Wm  # [M,6,2]
        H = torch.sum((JtW @ J) * w[:, None, None], dim=0) + 1e-6 * eye6
        b = -torch.sum((JtW @ e[..., None])[..., 0] * w[:, None], dim=0)
        dx = torch.linalg.solve_ex(H, b)[0]
        dR, dt = lie.se3_exp(dx)
        R, t = dR @ R, dR @ t + dt
    return R, t


def pnp_ransac(X, uv, valid, cam_params, key, n_hyp: int = 256, n_sample: int = 4,
               inlier_px: float = 5.0, refine_iters: int = 8, idx=None):
    """Batched P4P RANSAC for a camera pose from 3D-2D matches
    (relocalization): each minimal sample is solved by 12 Gauss-Newton
    steps from a rough pose, all hypotheses at once; the winner is refined
    on its inliers, then polished by ``mlpnp_refine``. ``idx``
    [n_hyp, n_sample] replaces the draw from ``key``.
    Returns (R_cw, t_cw, inlier_mask, n_inliers)."""
    dev, dt_ = X.device, X.dtype
    if idx is None:
        idx = _draw(key, valid, (n_hyp, n_sample))
    idx = idx.to(torch.int64)
    fx, fy, cx, cy = cam_params[0], cam_params[1], cam_params[2], cam_params[3]
    eye3 = torch.eye(3, dtype=dt_, device=dev)
    eye6 = torch.eye(6, dtype=dt_, device=dev)

    def project(R, t, P):
        pc = P @ R.transpose(-1, -2) + t[..., None, :]
        z = torch.clamp(pc[..., 2], min=1e-6)
        return torch.stack([fx * pc[..., 0] / z + cx, fy * pc[..., 1] / z + cy], dim=-1)

    def gn_refine(R, t, P, obs_uv, w, iters):
        for _ in range(iters):
            pc = P @ R.transpose(-1, -2) + t[..., None, :]
            z = torch.clamp(pc[..., 2], min=1e-6)
            pred = torch.stack([fx * pc[..., 0] / z + cx, fy * pc[..., 1] / z + cy], dim=-1)
            r = obs_uv - pred
            zi = 1.0 / z
            zero = torch.zeros_like(zi)
            Ju = torch.stack([fx * zi, zero, -fx * pc[..., 0] * zi * zi], -1)
            Jv = torch.stack([zero, fy * zi, -fy * pc[..., 1] * zi * zi], -1)
            Jproj = torch.stack([Ju, Jv], dim=-2)  # [...,M,2,3]
            dpc = torch.cat([eye3.expand(pc.shape + (3,)), -lie.hat(pc)], dim=-1)
            J = -(Jproj @ dpc)  # [...,M,2,6]
            Jt = J.transpose(-1, -2)
            H = torch.sum((Jt @ J) * w[..., None, None], dim=-3) + 1e-4 * eye6
            b = -torch.sum((Jt @ r[..., None])[..., 0] * w[..., None], dim=-2)
            dx = torch.linalg.solve_ex(H, b)[0]
            dR, dt = lie.se3_exp(dx)
            R, t = dR @ R, (dR @ t[..., None])[..., 0] + dt
        return R, t

    P = X[idx]  # [H, S, 3]
    c = P.mean(dim=-2)
    t0 = eye3[2] * torch.linalg.vector_norm(c, dim=-1, keepdim=True) - c
    R0 = eye3.expand(idx.shape[0], 3, 3)
    w0 = torch.ones(idx.shape, dtype=dt_, device=dev)
    Rs, ts = gn_refine(R0, t0, P, uv[idx], w0, 12)

    def inliers(R, t):
        err = torch.linalg.vector_norm(uv - project(R, t, X), dim=-1)
        depth_ok = (X @ R.transpose(-1, -2) + t[..., None, :])[..., 2] > 0.01
        return (err < inlier_px) & valid & depth_ok

    inls = inliers(Rs, ts)
    best = _first_max(torch.sum(inls, dim=-1))
    R, t = gn_refine(Rs[best][0], ts[best][0], X, uv, inls[best][0].to(dt_), refine_iters)
    inl = inliers(R, t)
    R, t = mlpnp_refine(X, uv, inl.to(dt_), cam_params, R, t, iters=4)
    inl = inliers(R, t)
    return R, t, inl, torch.sum(inl)
