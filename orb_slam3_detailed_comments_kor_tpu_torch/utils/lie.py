"""SO(3) / SE(3) Lie-group operations on torch tensors.

Port of ``orb_slam3_detailed_comments_kor_tpu/utils/lie.py`` (the functions
the stereo tracking step, the stereo SLAM loop and loop closing use). Same
conventions: rotations are 3x3 matrices; SE(3) is (R, t) acting as
x -> R @ x + t; Sim(3) is (R, t, s) acting as x -> s R x + t; ``T_ab`` maps
b-frame points to the a-frame. Small-angle branches are ``torch.where``
selections, so nothing here reads a value back to the host.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def _safe_norm(w):
    """(theta, theta_is_small) with the sqrt masked away from 0."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-12
    theta = torch.sqrt(torch.where(small, 1.0, theta2))
    return torch.where(small, 0.0, theta), small


def hat(w):
    """so(3) hat: [...,3] -> [...,3,3] skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W):
    """Inverse of hat: [...,3,3] -> [...,3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _sinc(x):
    """sin(x)/x, Taylor-safe."""
    small = torch.abs(x) < 1e-4
    xs = torch.where(small, 1.0, x)
    return torch.where(small, 1.0 - x * x / 6.0, torch.sin(xs) / xs)


def _cosc(x):
    """(1-cos(x))/x^2, Taylor-safe."""
    small = torch.abs(x) < 1e-4
    xs = torch.where(small, 1.0, x)
    return torch.where(small, 0.5 - x * x / 24.0, (1.0 - torch.cos(xs)) / (xs * xs))


def _sincc(x):
    """(x - sin(x))/x^3, Taylor-safe."""
    small = torch.abs(x) < 1e-4
    xs = torch.where(small, 1.0, x)
    return torch.where(
        small, 1.0 / 6.0 - x * x / 120.0, (xs - torch.sin(xs)) / (xs ** 3)
    )


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w):
    """Exponential map so(3) -> SO(3). w: [...,3] -> [...,3,3] (Rodrigues)."""
    theta, _ = _safe_norm(w)
    W = hat(w)
    W2 = W @ W
    a = _sinc(theta)[..., None, None]
    b = _cosc(theta)[..., None, None]
    return _eye_like(W) + a * W + b * W2


def so3_log(R):
    """Log map SO(3) -> so(3). [...,3,3] -> [...,3].

    Trace formula with a Taylor-safe theta/sin(theta) factor; near pi the
    axis comes from the diagonal of (R + R^T)/2, its signs anchored on the
    largest component.
    """
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    w_skew = vee(R - R.transpose(-1, -2)) * 0.5  # = sin(theta)*axis
    tiny = cos_t > 1.0 - 1e-6
    cos_safe = torch.clamp(torch.where(tiny, 0.0, cos_t), -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.where(tiny, 0.0, torch.arccos(cos_safe))
    sin_t = _sinc(theta)  # sin(theta)/theta
    generic = torch.where(
        tiny[..., None], w_skew, w_skew / torch.clamp(sin_t, min=_EPS)[..., None]
    )
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_abs = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, min=0.0))
    S = (R + R.transpose(-1, -2)) * 0.5
    i_max = torch.argmax(axis_abs, dim=-1, keepdim=True)  # [...,1]
    # column of S through the largest axis component, S[..., :, i_max]
    col = torch.gather(S, -1, i_max[..., None].expand(S.shape[:-1] + (1,)))[..., 0]
    s = torch.where(col < 0, -1.0, 1.0)
    s = s * torch.gather(s, -1, i_max)  # make the anchor positive
    near_pi = theta[..., None] * (axis_abs * s)
    use_pi = (theta > 3.0)[..., None]
    return torch.where(use_pi, near_pi, generic)


def so3_left_jacobian(w):
    """Left Jacobian of SO(3): [...,3] -> [...,3,3]."""
    theta, _ = _safe_norm(w)
    W = hat(w)
    W2 = W @ W
    return (
        _eye_like(W)
        + _cosc(theta)[..., None, None] * W
        + _sincc(theta)[..., None, None] * W2
    )


def project_to_so3(R, iters: int = 6):
    """Nearest rotation to a near-rotation matrix [...,3,3].

    The reference takes U·diag(1,1,det)·Vᵀ from an SVD; here the polar
    factor comes from Newton's iteration R ← (R + R⁻ᵀ)/2, with the inverse
    transpose as cofactor rows over the determinant. For a matrix with
    positive determinant (every pose update here) it is the same rotation,
    and unlike a CUDA SVD it never synchronises with the host.
    """
    for _ in range(iters):
        r0, r1, r2 = R[..., 0, :], R[..., 1, :], R[..., 2, :]
        c0 = torch.linalg.cross(r1, r2)
        c1 = torch.linalg.cross(r2, r0)
        c2 = torch.linalg.cross(r0, r1)
        det = torch.sum(r0 * c0, dim=-1)[..., None, None]
        R = 0.5 * (R + torch.stack([c0, c1, c2], dim=-2) / det)
    return R


# ---------------------------------------------------------------------------
# SE(3): pose = (R [...,3,3], t [...,3])
# ---------------------------------------------------------------------------

def _mv(R, x):
    return (R @ x[..., None])[..., 0]


def se3_exp(xi):
    """exp: [...,6] (rho, phi) -> (R, t). t = J_l(phi) @ rho.

    so3_exp and so3_left_jacobian share theta, W and W² here: eager torch
    would otherwise compute them twice (this runs in every LM iteration).
    """
    rho, phi = xi[..., :3], xi[..., 3:]
    theta, _ = _safe_norm(phi)
    W = hat(phi)
    W2 = W @ W
    eye = _eye_like(W)
    th = theta[..., None, None]
    R = eye + _sinc(th) * W + _cosc(th) * W2
    Jl = eye + _cosc(th) * W + _sincc(th) * W2
    return R, _mv(Jl, rho)


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -_mv(Rt, t)


def se3_compose(Ra, ta, Rb, tb):
    """T_a ∘ T_b = (Ra Rb, Ra tb + ta)."""
    return Ra @ Rb, _mv(Ra, tb) + ta


def se3_rel(Ra, ta, Rb, tb):
    """T_a ∘ T_b⁻¹."""
    Ri, ti = se3_inverse(Rb, tb)
    return se3_compose(Ra, ta, Ri, ti)


# The reference jits se3_compose into one dispatch for its host-side pose
# bookkeeping (keyframe save/restore); eager torch needs no separate form.
se3_compose_j = se3_compose


def so3_right_jacobian_inv(w):
    """Inverse right Jacobian, Taylor-safe."""
    theta, _ = _safe_norm(w)
    W = hat(w)
    W2 = W @ W
    small = theta < 1e-4
    ts = torch.where(small, 1.0, theta)
    # coefficient of W2: 1/θ² - (1+cosθ)/(2 θ sinθ)
    coef = torch.where(
        small,
        1.0 / 12.0 + theta * theta / 720.0,
        1.0 / (ts * ts) - (1.0 + torch.cos(ts)) / (2.0 * ts * torch.sin(ts)),
    )
    return _eye_like(W) + 0.5 * W + coef[..., None, None] * W2


def se3_log(R, t):
    """log: (R, t) -> [...,6] (rho, phi)."""
    phi = so3_log(R)
    Jl_inv = so3_right_jacobian_inv(-phi)  # J_l(phi)^{-1} = J_r(-phi)^{-1}
    return torch.cat([_mv(Jl_inv, t), phi], dim=-1)


# ---------------------------------------------------------------------------
# Sim(3): (R, t, s) with action x -> s·R·x + t
# ---------------------------------------------------------------------------

def sim3_apply(R, t, s, x):
    return s[..., None] * _mv(R, x) + t


def sim3_inverse(R, t, s):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return Rt, -s_inv[..., None] * _mv(Rt, t), s_inv


def sim3_compose(Ra, ta, sa, Rb, tb, sb):
    """S_a ∘ S_b: (Ra Rb, sa·Ra·tb + ta, sa·sb)."""
    return Ra @ Rb, sa[..., None] * _mv(Ra, tb) + ta, sa * sb


def _sim3_V(phi, theta, sigma, s):
    """The W matrix V = A I + B W + C W² of Sim(3) (Eade), Taylor-safe."""
    W = hat(phi)
    W2 = W @ W
    sig_small = torch.abs(sigma) < 1e-5
    sig_s = torch.where(sig_small, 1.0, sigma)
    A = torch.where(sig_small, 1.0 + sigma / 2.0, (s - 1.0) / sig_s)
    th_small = theta < 1e-5
    th_s = torch.where(th_small, 1.0, theta)
    sig2_th2 = sigma * sigma + theta * theta
    denom = torch.where(torch.abs(sig2_th2) < 1e-12, 1.0, sig2_th2)
    a_coef = s * torch.sin(th_s)
    b_coef = s * torch.cos(th_s)
    B_gen = (a_coef * sigma + (1.0 - b_coef) * th_s) / (th_s * denom)
    C_gen = (A - ((b_coef - 1.0) * sigma + a_coef * th_s) / denom) / (th_s * th_s)
    B = torch.where(th_small, 0.5 + sigma / 6.0, B_gen)
    C = torch.where(th_small, 1.0 / 6.0 + sigma / 24.0, C_gen)
    return A[..., None, None] * _eye_like(W) + B[..., None, None] * W + C[..., None, None] * W2


def sim3_exp(xi):
    """Sim(3) exp: [...,7] (rho, phi, sigma) -> (R, t, s)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    theta, _ = _safe_norm(phi)
    s = torch.exp(sigma)
    return so3_exp(phi), _mv(_sim3_V(phi, theta, sigma, s), rho), s


def sim3_log(R, t, s):
    """Sim(3) log -> [...,7]; inverse of sim3_exp (V solved)."""
    phi = so3_log(R)
    sigma = torch.log(s)
    theta = torch.linalg.vector_norm(phi, dim=-1)
    V = _sim3_V(phi, theta, sigma, s)
    rho = torch.linalg.solve_ex(V, t[..., None])[0][..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)
