"""Pinhole camera model on torch tensors.

Port of the pinhole part of ``orb_slam3_detailed_comments_kor_tpu/models/
camera.py`` and of its radial-tangential distortion (``distort_radtan``,
``undistort_radtan``). ``params`` is [fx, fy, cx, cy]; 3-D points are
camera-frame, z forward; all functions broadcast over leading batch dims.
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


def project(params, xyz, model: str = "pinhole"):
    if model != "pinhole":
        raise NotImplementedError(f"camera model {model!r} is not ported")
    return pinhole_project(params, xyz)


def unproject(params, uv, model: str = "pinhole"):
    if model != "pinhole":
        raise NotImplementedError(f"camera model {model!r} is not ported")
    return pinhole_unproject(params, uv)


def camera_params_from_config(cam, device="cuda") -> torch.Tensor:
    """[fx, fy, cx, cy] float32 from a pinhole CameraConfig, on ``device``
    (the card unless the caller names another)."""
    if cam.model != "pinhole":
        raise NotImplementedError(f"camera model {cam.model!r} is not ported")
    return torch.tensor(
        [cam.fx, cam.fy, cam.cx, cam.cy], dtype=torch.float32, device=device
    )
