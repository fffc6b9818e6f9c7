"""Two-view reconstruction for the monocular bootstrap.

Port of ``orb_slam3_detailed_comments_kor_tpu/ops/twoview.py`` (the
counterpart of ``TwoViewReconstruction``): a fixed budget of 8-point
essential-matrix hypotheses and of 4-point homography hypotheses, each
batch scored in one pass (Sampson and symmetric transfer errors), the
winner decomposed into its motion candidates and voted by cheirality and
parallax; the homography wins when it explains clearly more points and
has a clear cheirality winner (``reconstruct_two_views_hf``).

The hypotheses are drawn by ``utils.prng`` from the caller's key, split
as ``jax.random.split`` splits it, so both packages evaluate the same
samples. The small SVDs are not LAPACK's: the 8x9 null vectors come from
a Householder QR in float64 and the 3x3 decompositions from a Jacobi
eigen-solve in float64 (``ransac._jacobi_eigh3``). Neither reads the
device back, and every quantity the reference uses from an SVD -- the
null vector up to sign, the projection onto the essential manifold, the
set of motion candidates -- does not depend on the singular vectors'
signs or, for E's equal singular values, on their rotation; only the
order of the candidates may differ from LAPACK's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_detailed_comments_kor_tpu_torch.ops import ransac
from orb_slam3_detailed_comments_kor_tpu_torch.utils import prng


def _null_vector(A):
    """Unit null vector of [..., n-1, n] matrices, float64: the last column
    of the full Q of Aᵀ = Q R, by Householder reflections."""
    M = A.to(torch.float64).transpose(-1, -2).clone()  # [..., n, m]
    n, m = M.shape[-2], M.shape[-1]
    refl = []
    for k in range(m):
        x = M[..., k:, k]
        alpha = torch.where(x[..., :1] >= 0, -1.0, 1.0) * torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        v = torch.cat([x[..., :1] - alpha, x[..., 1:]], dim=-1)
        vv = torch.clamp(torch.sum(v * v, dim=-1), min=1e-300)
        sub = M[..., k:, k:]
        M[..., k:, k:] = sub - (2.0 / vv)[..., None, None] * v[..., :, None] * (v[..., None, :] @ sub)
        refl.append((k, v, vv))
    lead = M.shape[:-2]
    q = torch.cat([torch.zeros(lead + (n - 1,), dtype=torch.float64, device=A.device),
                   torch.ones(lead + (1,), dtype=torch.float64, device=A.device)], dim=-1)
    for k, v, vv in reversed(refl):
        tail = q[..., k:]
        q = torch.cat([q[..., :k], tail - (2.0 * torch.sum(v * tail, dim=-1) / vv)[..., None] * v], dim=-1)
    return q


def _det3(M):
    return torch.sum(M[..., :, 0] * torch.linalg.cross(M[..., :, 1], M[..., :, 2]), dim=-1)


def _svd3(M):
    """SVD of [..., 3, 3] matrices in float64: (U, S descending, V), with
    M = U·diag(S)·Vᵀ. V from a Jacobi eigen-solve of MᵀM; u_i = M v_i / σ_i,
    u2 orthogonalized against u1, u3 = ±u1×u2 (the sign of M v3)."""
    Md = M.to(torch.float64)
    lam, V = ransac._jacobi_eigh3(Md.transpose(-1, -2) @ Md)
    order = torch.argsort(lam, dim=-1, descending=True)
    lam = torch.gather(lam, -1, order)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    S = torch.sqrt(torch.clamp(lam, min=0.0))
    MV = Md @ V
    u1 = ransac._unit(MV[..., :, 0])
    u2 = MV[..., :, 1] - torch.sum(u1 * MV[..., :, 1], -1, keepdim=True) * u1
    eye = torch.eye(3, dtype=torch.float64, device=M.device)
    axis = torch.where(torch.abs(u1[..., :1]) < 0.9, eye[0], eye[1])
    rank2 = S[..., 1] > 1e-12 * torch.clamp(S[..., 0], min=1e-300)
    u2 = ransac._unit(torch.where(rank2[..., None], u2, torch.linalg.cross(u1, axis)))
    u3 = torch.linalg.cross(u1, u2)
    u3 = u3 * torch.where(torch.sum(u3 * MV[..., :, 2], -1, keepdim=True) < 0, -1.0, 1.0)
    return torch.stack([u1, u2, u3], dim=-1), S, V


def _essential_from_8(ra, rb):
    """8-point linear E: ra/rb [..., 8, 3] normalized rays (z=1), E maps a
    to b. Returns [..., 3, 3] projected to singular values (1, 1, 0)."""
    x1, y1 = ra[..., 0], ra[..., 1]
    x2, y2 = rb[..., 0], rb[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, torch.ones_like(x1)], dim=-1)
    E = _null_vector(A).reshape(A.shape[:-2] + (3, 3))
    U, _, V = _svd3(E)
    Ep = U[..., :, :2] @ V[..., :, :2].transpose(-1, -2)  # U diag(1, 1, 0) Vᵀ
    return Ep.to(ra.dtype)


def _sampson(E, ra, rb):
    """First-order geometric (Sampson) error per correspondence: E [..., 3,
    3], rays [M, 3] -> [..., M]."""
    Ex1 = ra @ E.transpose(-1, -2)   # E @ ra
    Etx2 = rb @ E                    # Eᵀ @ rb
    x2tEx1 = torch.sum(rb * Ex1, dim=-1)
    denom = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return (x2tEx1 ** 2) / torch.clamp(denom, min=1e-12)


def triangulate_midpoint(R_ba, t_ba, rays_a, rays_b):
    """Midpoint triangulation in frame a. R_ba/t_ba: the a->b transform
    (leading batch dims broadcast with the rays'). Returns (X_a [..., M,
    3], depth_a [..., M], depth_b [..., M])."""
    db = rays_b @ R_ba                                   # R_ab @ rays_b
    ob = -(t_ba[..., None, :] @ R_ba)[..., 0, :]          # camera b's centre in frame a
    aa = torch.sum(rays_a * rays_a, -1)
    bb = torch.sum(db * db, -1)
    ab = torch.sum(rays_a * db, -1)
    aw = torch.sum(rays_a * ob[..., None, :], -1)
    bw = torch.sum(db * ob[..., None, :], -1)
    # closest points on the two rays: s·aa − u·ab = aw ; s·ab − u·bb = bw
    den = torch.clamp(aa * bb - ab * ab, min=1e-12)
    s = (aw * bb - bw * ab) / den
    u = (aw * ab - bw * aa) / den
    Pa = rays_a * s[..., None]
    Pb = ob[..., None, :] + db * u[..., None]
    X = 0.5 * (Pa + Pb)
    Xb = X @ R_ba.transpose(-1, -2) + t_ba[..., None, :]
    return X, X[..., 2], Xb[..., 2]


class TwoViewResult(NamedTuple):
    ok: torch.Tensor        # scalar bool
    R_ba: torch.Tensor      # [3,3] rotation a->b
    t_ba: torch.Tensor      # [3] unit-norm translation a->b
    X: torch.Tensor         # [M,3] triangulated points in frame a
    inlier: torch.Tensor    # [M] bool (model inlier & cheirality & parallax)
    n_good: torch.Tensor    # scalar int


def _parallax_cos(R_ba, t_ba, X):
    """Cosine of the angle between the two rays at each triangulated point."""
    ob = -(t_ba[..., None, :] @ R_ba)[..., 0, :]
    v1 = X / torch.clamp(torch.linalg.vector_norm(X, dim=-1, keepdim=True), min=1e-9)
    v2 = X - ob[..., None, :]
    v2 = v2 / torch.clamp(torch.linalg.vector_norm(v2, dim=-1, keepdim=True), min=1e-9)
    return torch.sum(v1 * v2, dim=-1)


def _pick(x, i):
    """x[i] for a 1-element index tensor, without a host read."""
    return x[i][0]


def reconstruct_two_views(rays_a, rays_b, valid, key, n_hyp: int = 256, inlier_th: float = 3e-6,
                          min_parallax_cos: float = 0.9998) -> TwoViewResult:
    """Monocular bootstrap through E: RANSAC, decomposition, cheirality,
    triangulation. rays_a/b [M,3] unit-depth rays of matched features;
    inlier_th is the Sampson threshold on normalized coords."""
    idx = ransac._draw(key, valid, (n_hyp, 8)).to(torch.int64)
    Es = _essential_from_8(rays_a[idx], rays_b[idx])           # [H,3,3]
    inls = (_sampson(Es, rays_a, rays_b) < inlier_th) & valid  # [H,M]
    counts = torch.sum(inls, dim=-1)
    best = ransac._first_max(counts)
    E, inl_e = _pick(Es, best), _pick(inls, best)

    # decompose: E = U diag(1,1,0) Vᵀ; R in {U W Vᵀ, U Wᵀ Vᵀ}, t = ±U[:,2]
    U, _, V = _svd3(E)
    U = U * torch.where(_det3(U) * _det3(V) < 0, -1.0, 1.0)  # det(R) = +1
    eye = torch.eye(3, dtype=torch.float64, device=E.device)
    W = torch.stack([-eye[1], eye[0], eye[2]])
    Vt = V.transpose(-1, -2)
    R1, R2 = (U @ W @ Vt).to(E.dtype), (U @ W.T @ Vt).to(E.dtype)
    t_u = U[:, 2].to(E.dtype)
    Rc = torch.stack([R1, R1, R2, R2])
    tc = torch.stack([t_u, -t_u, t_u, -t_u])
    Xs, da, db = triangulate_midpoint(Rc, tc, rays_a, rays_b)
    oks = inl_e & (da > 0.0) & (db > 0.0)
    best4 = ransac._first_max(torch.sum(oks, dim=-1))
    R_ba, t_ba, X, good = _pick(Rc, best4), _pick(tc, best4), _pick(Xs, best4), _pick(oks, best4)

    # parallax gate: the angle between the two rays at the point
    good = good & (_parallax_cos(R_ba, t_ba, X) < min_parallax_cos)
    n_good = torch.sum(good)
    ok = (n_good >= 50) & (n_good >= 0.5 * torch.clamp(_pick(counts, best), min=1))
    return TwoViewResult(ok=ok, R_ba=R_ba, t_ba=t_ba, X=X, inlier=good, n_good=n_good)


def _homography_from_4(ra, rb):
    """DLT homography from 4 ray pairs [..., 4, 3] (normalized coords x/z,
    y/z): H [..., 3, 3] with rb ~ H ra, unit Frobenius norm."""
    xa, ya = ra[..., 0] / ra[..., 2], ra[..., 1] / ra[..., 2]
    xb, yb = rb[..., 0] / rb[..., 2], rb[..., 1] / rb[..., 2]
    zero = torch.zeros_like(xa)
    one = torch.ones_like(xa)
    r1 = torch.stack([xa, ya, one, zero, zero, zero, -xb * xa, -xb * ya, -xb], dim=-1)
    r2 = torch.stack([zero, zero, zero, xa, ya, one, -yb * xa, -yb * ya, -yb], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # [..., 8, 9]
    return _null_vector(A).reshape(A.shape[:-2] + (3, 3)).to(ra.dtype)


def _h_transfer_err2(H, ra, rb):
    """Symmetric transfer error² in normalized coords: H [..., 3, 3], rays
    [M, 3] -> [..., M]."""
    pa = ra / ra[:, 2:3]
    pb = rb / rb[:, 2:3]

    def dehom(q):
        z = q[..., 2:3]
        return q / torch.where(torch.abs(z) < 1e-12, 1e-12, z)

    q = dehom(pa @ H.transpose(-1, -2))
    e_fwd = torch.sum((q[..., :2] - pb[:, :2]) ** 2, dim=-1)
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    Hi = torch.linalg.inv_ex(H + 1e-12 * eye)[0]
    qi = dehom(pb @ Hi.transpose(-1, -2))
    e_bwd = torch.sum((qi[..., :2] - pa[:, :2]) ** 2, dim=-1)
    return e_fwd + e_bwd


def _decompose_homography(H):
    """Faugeras SVD decomposition of a calibrated homography into its 8
    (R, t) motion hypotheses (``Initializer::ReconstructH``; Faugeras &
    Lustman 1988). Returns (R [8,3,3], t [8,3]) with ‖t‖ = 1."""
    U, dv, V = _svd3(H)
    s = _det3(U) * _det3(V)
    d1, d2, d3 = dv[0], dv[1], dv[2]
    denom = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    x1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / denom, min=0.0))
    x3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / denom, min=0.0))
    d2s = torch.clamp(d2, min=1e-12)
    # (e1, e3) in the reference's loop order: (+,+), (+,-), (-,+), (-,-)
    k = torch.arange(4, device=H.device)
    e1 = torch.where(k < 2, 1.0, -1.0).to(torch.float64)
    e3 = torch.where(k % 2 == 0, 1.0, -1.0).to(torch.float64)
    zero, one = torch.zeros_like(e1), torch.ones_like(e1)
    # case d' = +d2
    st = (d1 - d3) * (e1 * x1) * (e3 * x3) / d2s
    ct = (d1 * x3 * x3 + d3 * x1 * x1) / d2s * one
    Rp_a = torch.stack([torch.stack([ct, zero, -st], -1), torch.stack([zero, one, zero], -1),
                        torch.stack([st, zero, ct], -1)], dim=-2)
    tp_a = torch.stack([e1 * x1, zero, -e3 * x3], -1) * (d1 - d3)
    # case d' = -d2 (the reflection branch)
    sphi = (d1 + d3) * (e1 * x1) * (e3 * x3) / d2s
    cphi = (d3 * x1 * x1 - d1 * x3 * x3) / d2s * one
    Rp_b = torch.stack([torch.stack([cphi, zero, sphi], -1), torch.stack([zero, -one, zero], -1),
                        torch.stack([sphi, zero, -cphi], -1)], dim=-2)
    tp_b = torch.stack([e1 * x1, zero, e3 * x3], -1) * (d1 + d3)
    Rp = torch.cat([Rp_a, Rp_b])
    tp = torch.cat([tp_a, tp_b])
    R8 = s * (U @ Rp @ V.transpose(-1, -2))
    t8 = tp @ U.transpose(-1, -2)
    t8 = t8 / torch.clamp(torch.linalg.vector_norm(t8, dim=-1, keepdim=True), min=1e-12)
    return R8.to(H.dtype), t8.to(H.dtype)


def reconstruct_two_views_hf(rays_a, rays_b, valid, key, n_hyp: int = 256, inlier_th: float = 3e-6,
                             min_parallax_cos: float = 0.9998) -> TwoViewResult:
    """Monocular bootstrap with E/H model selection: the essential-matrix
    RANSAC and a homography RANSAC on the same correspondences; the motion
    comes from the Faugeras decomposition when the homography explains
    clearly more inliers (R_H = S_H/(S_H+S_F) > 0.45) and has a clear
    cheirality winner, else from E (``TwoViewReconstruction``)."""
    keys = prng.split(key)
    res_e = reconstruct_two_views(rays_a, rays_b, valid, keys[0], n_hyp=n_hyp, inlier_th=inlier_th,
                                  min_parallax_cos=min_parallax_cos)
    idx = ransac._draw(keys[1], valid, (n_hyp, 4)).to(torch.int64)
    Hs = _homography_from_4(rays_a[idx], rays_b[idx])
    inls_h = (_h_transfer_err2(Hs, rays_a, rays_b) < 4.0 * inlier_th) & valid
    counts_h = torch.sum(inls_h, dim=-1)
    best_h = ransac._first_max(counts_h)
    H, inl_h = _pick(Hs, best_h), _pick(inls_h, best_h)
    n_h = _pick(counts_h, best_h).to(torch.float32)
    n_e = res_e.n_good.to(torch.float32)

    # the Faugeras hypotheses, scored by cheirality and parallax over the
    # homography's inliers
    R8, t8 = _decompose_homography(H)
    X8, da, db = triangulate_midpoint(R8, t8, rays_a, rays_b)
    ok8 = inl_h & (da > 0.0) & (db > 0.0) & (_parallax_cos(R8, t8, X8) < min_parallax_cos)
    counts8 = torch.sum(ok8, dim=-1)
    b8 = ransac._first_max(counts8)
    second = torch.sort(counts8).values[-2]
    n_good_h = _pick(counts8, b8)
    # a clear cheirality winner is needed before H is accepted
    h_ok = (n_good_h >= 50) & (second.to(torch.float32) < 0.75 * n_good_h.to(torch.float32))
    ratio_h = n_h / torch.clamp(n_h + n_e, min=1.0)
    use_h = (ratio_h > 0.45) & h_ok
    return TwoViewResult(
        ok=use_h | res_e.ok,
        R_ba=torch.where(use_h, _pick(R8, b8), res_e.R_ba),
        t_ba=torch.where(use_h, _pick(t8, b8), res_e.t_ba),
        X=torch.where(use_h, _pick(X8, b8), res_e.X),
        inlier=torch.where(use_h, _pick(ok8, b8), res_e.inlier),
        n_good=torch.where(use_h, n_good_h, res_e.n_good),
    )
