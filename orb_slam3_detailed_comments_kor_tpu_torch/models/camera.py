"""Camera models on torch tensors: pinhole and Kannala-Brandt 8.

Port of ``orb_slam3_detailed_comments_kor_tpu/models/camera.py``: the
pinhole model with its radial-tangential distortion (``distort_radtan``,
``undistort_radtan``) and the equidistant fisheye model
(``KannalaBrandt8.cpp``), dispatched by model name. ``params`` is
  pinhole: [fx, fy, cx, cy]
  kb8:     [fx, fy, cx, cy, k0, k1, k2, k3], r(θ) = θ + k0·θ³ + k1·θ⁵ + k2·θ⁷ + k3·θ⁹
3-D points are camera-frame, z forward; all functions broadcast over
leading batch dims.
"""

from __future__ import annotations

import torch

_EPS = 1e-9


def pinhole_project(params, xyz):
    """Camera-frame points [...,3] -> pixels [...,2]. No distortion."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    z = torch.clamp(xyz[..., 2], min=_EPS)
    u = fx * xyz[..., 0] / z + cx
    v = fy * xyz[..., 1] / z + cy
    return torch.stack([u, v], dim=-1)


def pinhole_unproject(params, uv):
    """Pixels [...,2] -> unit-depth rays [...,3] (z=1)."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def pinhole_project_jac(params, xyz):
    """d(uv)/d(xyz) [...,2,3] of ``pinhole_project``."""
    fx, fy = params[0], params[1]
    x, y = xyz[..., 0], xyz[..., 1]
    zi = 1.0 / torch.clamp(xyz[..., 2], min=_EPS)
    zi2 = zi * zi
    zeros = torch.zeros_like(x)
    row0 = torch.stack([fx * zi, zeros, -fx * x * zi2], dim=-1)
    row1 = torch.stack([zeros, fy * zi, -fy * y * zi2], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def distort_radtan(dist, xn):
    """Radial-tangential distortion of normalized coords [...,2].

    dist = (k1, k2, p1, p2[, k3]): Python floats or a float32 tensor.
    """
    k1, k2, p1, p2 = dist[0], dist[1], dist[2], dist[3]
    k3 = dist[4] if len(dist) > 4 else 0.0
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_radtan(dist, xd, iters: int = 8):
    """Invert ``distort_radtan`` by a fixed number of fixed-point steps
    (cv::undistortPoints equivalent)."""
    xn = xd
    for _ in range(iters):
        xn = xd - (distort_radtan(dist, xn) - xn)
    return xn


# ---------------------------------------------------------------------------
# Kannala-Brandt 8 (equidistant fisheye), KannalaBrandt8.cpp
# ---------------------------------------------------------------------------

def _kb8_poly(theta, k):
    """d(θ) = θ(1 + k0θ² + k1θ⁴ + k2θ⁶ + k3θ⁸) and its derivative."""
    t2 = theta * theta
    d = theta * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3]))))
    dp = 1.0 + t2 * (3 * k[0] + t2 * (5 * k[1] + t2 * (7 * k[2] + t2 * 9 * k[3])))
    return d, dp


def kb8_project(params, xyz):
    """Fisheye projection (KannalaBrandt8::project, KannalaBrandt8.cpp:46);
    points on the optical axis project to the principal point."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    r = torch.sqrt(x * x + y * y)
    d, _ = _kb8_poly(torch.atan2(r, z), params[4:8])
    r_safe = torch.clamp(r, min=_EPS)
    on_axis = r < _EPS
    u = torch.where(on_axis, cx, fx * d * x / r_safe + cx)
    v = torch.where(on_axis, cy, fy * d * y / r_safe + cy)
    return torch.stack([u, v], dim=-1)


def kb8_unproject(params, uv, iters: int = 10):
    """Inverse of the equidistant polynomial by ``iters`` Newton steps
    (KannalaBrandt8::unprojectEig, KannalaBrandt8.cpp:237-291), as
    unit-depth rays [...,3]. Past θ = π/2 (the corners of a wide fisheye
    image) tan θ turns negative and the ray flips, as in the reference."""
    fx, fy, cx, cy = params[0], params[1], params[2], params[3]
    k = params[4:8]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    d = torch.sqrt(mx * mx + my * my)  # the distorted radius r(θ)
    theta = d
    for _ in range(iters):
        f, fp = _kb8_poly(theta, k)
        theta = theta - (f - d) / torch.clamp(fp, min=_EPS)
    scale = torch.where(d < _EPS, 1.0, torch.tan(theta) / torch.clamp(d, min=_EPS))
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)


def kb8_project_jac(params, xyz):
    """d(uv)/d(xyz) [...,2,3] of ``kb8_project``, written out: with
    ρ² = r² + z², θ = atan2(r, z) and d' = dd/dθ,
    du/dx = fx (d' z x² / (ρ² r²) + d y² / r³), du/dy = fx xy (d' z / (ρ² r²)
    - d / r³), du/dz = -fx d' x / ρ², and v alike. On the optical axis it
    is zero, as the reference's forward-mode derivative through its
    principal-point branch is."""
    fx, fy = params[0], params[1]
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    r2 = x * x + y * y
    r = torch.sqrt(r2)
    d, dp = _kb8_poly(torch.atan2(r, z), params[4:8])
    r_safe = torch.clamp(r, min=_EPS)
    rho2 = r2 + z * z
    a = dp * z / (rho2 * r_safe * r_safe)  # d' dθ/dr / r
    b = d / (r_safe * r_safe * r_safe)     # d / r³
    c = -dp / rho2                          # d' dθ/dz / r · r
    row0 = torch.stack([fx * (a * x * x + b * y * y), fx * x * y * (a - b), fx * c * x], dim=-1)
    row1 = torch.stack([fy * x * y * (a - b), fy * (a * y * y + b * x * x), fy * c * y], dim=-1)
    J = torch.stack([row0, row1], dim=-2)
    return torch.where((r < _EPS)[..., None, None], 0.0, J)


# ---------------------------------------------------------------------------
# Static dispatch
# ---------------------------------------------------------------------------

_MODELS = {
    "pinhole": (pinhole_project, pinhole_unproject, pinhole_project_jac),
    "kannala_brandt8": (kb8_project, kb8_unproject, kb8_project_jac),
}


def make_camera(model: str):
    """(project, unproject, project_jac) of a model name."""
    if model not in _MODELS:
        raise ValueError(f"unknown camera model {model!r}")
    return _MODELS[model]


def project(params, xyz, model: str = "pinhole"):
    """Camera-frame points [...,3] -> pixels [...,2] (GeometricCamera::project)."""
    return make_camera(model)[0](params, xyz)


def unproject(params, uv, model: str = "pinhole"):
    """Pixels [...,2] -> unit-depth rays [...,3]."""
    return make_camera(model)[1](params, uv)


def project_jac(params, xyz, model: str = "pinhole"):
    """d(uv)/d(xyz) [...,2,3]."""
    return make_camera(model)[2](params, xyz)


def camera_params_from_config(cam, device="cuda") -> torch.Tensor:
    """The params vector of a CameraConfig as float32 on ``device`` (the
    card unless the caller names another): [fx, fy, cx, cy], and for KB8
    the four polynomial coefficients from ``dist`` after them."""
    vals = [cam.fx, cam.fy, cam.cx, cam.cy]
    if cam.model == "kannala_brandt8":
        vals += (list(cam.dist[:4]) + [0.0] * 4)[:4]
    elif cam.model != "pinhole":
        raise ValueError(cam.model)
    return torch.tensor(vals, dtype=torch.float32, device=device)
